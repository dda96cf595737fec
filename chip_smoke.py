"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the kernels' ``sm_90a`` build) and the
CUDA toolkit; exits non-zero without them. Phases, each fatal on failure:

  1. device  — the card's name and power limit (``nvidia-smi``);
  2. build   — compile the five CUDA sources with nvcc, one process each,
               all started together: simjoin.cu is waited for, the three
               attention sources and adamw.cu build on while the join
               group (3-6) runs and are waited for after it (seconds, ptxas
               registers / static shared memory / spills of every
               kernel, and the dynamic shared memory of each flash
               kernel);
  3. kernels — both CUDA kernels against their plain PyTorch versions on
               the card, exact per-block-pair equality over a sweep of
               d, eps, cross/self joins, ragged sizes, large coordinates,
               batched stacks and pair lists with pad rows, then the
               walkers' edge cases (d = 1 and 4, coordinates at +-2^21
               and beyond in one launch so both the fp32 and the int32
               branch run, eps 0 and >= 2^24, lists that change task and
               block_i inside each warp's range, sorted and shuffled, pad
               rows mid-list); kernel times at k=8, Na=Nb=8192, d=3, back
               to back and in a CUDA graph, with each kernel's share of
               its bound;
  4. geo     — the clustered GEO workload on ``backend="torch_device"``
               under every prune mode, held to its exact match and
               block-pair counts;
  5. ptf     — the main path: the PTF deployment (32 hdf5 files, 8
               nodes on one card, ptf2 queries at eps=300) with
               prune="auto" through ``RawArrayCluster.run_workload``,
               launch counts set to 0 before and read after that run,
               then the whole workload with ``impl="plain"`` on the
               card, equal per query and in every non-timing summary
               key (the replay takes the first run's bitmap sidecars and
               refined pair lists, which the same host code built, in
               place of building them again); the largest dense and pair-list batches of the run
               are replayed through kernel and plain version, compared
               and timed (per launch back to back from Python, the JSON
               ``ms``, and in a CUDA graph of 100 launches, ``graph_ms``,
               the card's time alone). It runs at 50,000 cells per file (2.6 M
               cells): at the deployment's 100,000 the host-side
               bitmap refinement of prune="auto" alone outlasts the
               run's time limit;
  6. ptf-full — the deployment at full size (5.2 M cells) with
               prune="block" (no bitmap stage, pair-list kernel only),
               kernel run against plain run the same way;
  7. attn    — the flash and paged attention kernels against their plain
               versions on the sweeps of the reference's kernel tests
               (fp32 within 2e-5, bf16 within 2e-2 / 3e-2), the bf16
               flash kernel at every head dim (ragged Sk, q_offset) and
               the fp32 one at head dim 16, the paged kernel at every
               split count, at head dims 16, 80 and 192 with a GQA group
               of 12 and at 16 with 4 query heads (the reduced configs'),
               and both at the serving slice's own shapes;
  8. prefill — llama3.2-3b at full width and depth (28 layers, random
               bf16 weights from a seed) through ``make_prefill_step`` on
               B=2 x S=4096 tokens: "auto" takes the blockwise path, so
               the flash kernel launches once per layer; its logits held
               against the same step on the plain versions within the
               stated bounds, beside the floor of two plain formulations
               (naive and blockwise attention) of the same step;
  9. serve   — ``ServingEngine`` with the same model: 4 slots, max_len
               512, 16-token pages, cost policy, 4 requests of a shared
               192-token system prompt plus 64 tokens each, 16 new
               tokens; every decode step (prompt replay included) goes
               through the paged kernel once per layer. The run is then
               replayed teacher-forced on the plain versions, every
               step's logits compared within the same bounds, the
               EngineStats equal, beside a floor engine as in 16 (every
               prefill and serving phase runs these same two checks,
               ``prefill_check`` and ``serve_check``). Two windows of the run's calls (prompt
               replay, batched decode) are re-run for ms per step and,
               under torch.profiler, the card's busy share; the first
               layer's paged call of a B = 1 prompt-replay step (slot 0,
               position 159) and of every batched step are kept;
 10. replay  — flash at the prefill's shape (kernel, plain and
               ``F.scaled_dot_product_attention`` times, TFLOP/s, bound)
               and paged at both kept serving calls (B = 1 replay, and
               the B = 4 batched call with the most live positions):
               the split count it chose, kernel time per launch back
               to back from Python (the JSON ``ms``) and in a CUDA graph
               of 100 launches (``graph_ms``: device time, free of the
               host's launch cost), plain and SDPA times, bound;
 11. train-kernels — the flash backward kernels against
               ``attention_bwd_ref`` on the same forward (out, lse): at
               the training shape (B 2, S 4096, 24/8 heads of 128,
               causal, bf16) and on an edge sweep (fp32 and bf16, every
               head dim, GQA rep 1 and 3, ragged non-causal Sk,
               q_offset, causal S 200 and 384 across the bf16 kernels'
               tiles, padded S through autograd of the model's
               blockwise path); the forward kernels' lse against the
               plain one; two launches equal bit for bit;
 12. train   — llama3.2-3b trained at full width and depth (bf16
               params, fp32 AdamW moments, remat per layer) on B 2 x S
               4096 batches from the raw-array token pipeline (8 HDF5
               files of documents up to 4097 tokens from ``--seed``, 4
               hosts, cost policy): the first step's loss, grad norm and
               every leaf's gradient against the plain versions' within
               the stated bounds, beside the floor of two plain
               backward formulations; then 4 timed steps of
               ``make_train_step`` with the launch counts set to 0 before
               and read after (flash forward twice a layer under remat,
               the backward once a layer), step time, tokens/s, MFU, peak
               memory, one more step under torch.profiler (busy and idle
               share, the flash kernels' device time), PipelineStats;
 13. replay[flash_attention_bwd] — the backward at the training shape:
               kernel (back to back and in a CUDA graph; the delta,
               dK/dV and dQ kernels each from a profiled graph replay),
               plain, SDPA's backward alone, bound;
 14. resume  — the same model reduced (d_model 512, 2 layers, vocab
               512) at S 4096: 4 steps with a checkpoint after step 2;
               params, moments and the pipeline's state restored into
               fresh tensors and a fresh pipeline, steps 3-4 again:
               losses and final parameters equal bit for bit;
 15. moe-prefill — deepseek-moe-16b at full width and depth (28
               layers, 16 / 16 heads, 64 experts of 1408 top-6 + 2
               shared, capacity_factor 1.25, random bf16 weights) through
               ``make_prefill_step`` on B 2 x S 4096: 28 flash launches,
               dropped pairs per layer and the aux loss, under the
               routing rule (ROUTING_MARGIN, FLOOR_FACTOR): the routing
               shares of the kernel and plain runs beside the floor of
               two plain formulations, the logits where the routing
               agreed and on a plain run forced onto the kernel run's
               experts, beside their floors;
 16. moe-serve — the same weights in ``ServingEngine`` (4 slots,
               max_len 256, 16-token pages, cost policy, 6 requests of a
               64-token shared prompt + 32 own, 8 new each): every
               prompt-replay step runs all 4 lanes (counted), the paged
               kernel once a layer and call; a plain engine replays the
               run teacher-forced and forced onto its routing (logits at
               every call, EngineStats), a floor engine the first
               FLOOR_CALLS calls with the reference's rounding of decode
               attention; each token the plain argmax would change is
               printed with its call's routing flips;
 17. replay[flash MHA] — flash forward and backward at deepseek's
               multi-head shape (B 2, S 4096, 16 / 16 heads of 128)
               beside SDPA, the forward also within a relative L2 error
               of FLASH_REPLAY_REL_L2;
 18. moe-train — deepseek-moe-16b at full width and 4 of 28 layers on
               B 1 x S 4096 from the token pipeline: first-step
               gradients against the plain step on the kernel run's
               routing beside a floor, routing shares, two kernel steps
               equal bit for bit, remat's recompute routing as its
               forward, then 1 + 3 timed steps (launches, tokens/s, MFU
               over active parameters, aux losses, peak memory);
 19. ssm     — xlstm-125m at full size: the mLSTM's chunkwise and
               sequential forms' gradients on fp32 weights, 1 + 2 timed
               bf16 steps at B 2 x S 2048, one profiled step (the sLSTM
               recurrences' share of device time), the engine (4 slots,
               4 requests of 64 + 8 tokens), decode against the forward;
 20. jamba   — Jamba reduced to 8 layers (d_model 512, 7 Mamba + 1
               attention, MoE every other layer, capacity_factor 1.25):
               prefill on B 2 x S 4096 and the engine, each as in 15 and
               16;
 21. hubert  — hubert-xlarge at full size (48 layers, d_model 1280, 16
               heads of 80, non-causal, vocab 504, random bf16 weights):
               prefill on B 2 x S 4096 seeded frame embeddings (48 flash
               launches at D 80), held against the plain step within the
               stated bounds, beside the floor of two plain formulations;
               training at B 2 x S 4096 with seeded masked-unit labels,
               remat per layer: the first step's loss, grad norm and
               worst leaf against the plain step within the stated
               bounds, beside its floor, 1 warm-up + 2 timed steps
               (launches, step time, MFU, peak memory), one more step
               under torch.profiler; the flash forward and backward at
               its shape as in 17 (back to back, CUDA graph, plain, SDPA,
               bound);
 22. nemotron — nemotron-4-340b at full width (d_model 18432, 96 / 8
               heads of 192, squared-ReLU d_ff 73728, vocab 256000) and 2
               of 96 layers: prefill on B 1 x S 4096 (flash at D 192, GQA
               12) held as in 21; the engine (4 slots, max_len 512, 4
               requests of 64 shared + 32 own tokens, 8 new) through the
               paged kernel at D 192, replayed teacher-forced on the
               plain versions as in 16; the flash forward and backward at
               its shape and the paged kernel at its batched call;
 23. archs   — qwen1.5-0.5b, olmo-1b and internvl2-2b (256 patch
               embeddings, then text) at full width and depth, and at
               full width phi3.5-moe-42b-a6.6b at 8 of 32 layers and
               jamba-1.5-large-398b at the first 4 of its 72 (3 Mamba,
               1 attention, MoE on two; the routed two under the routing
               rule): each a prefill on B 1 x S 4096
               held as in 21 and an engine run (4 slots, max_len 128, 4
               requests of 8 shared + 8 own tokens, 8 new: 8 batched
               decode steps) held as in 16;
 24. adamw   — the AdamW kernels on the benchmark cell's deepseek-moe-16b
               tree (4 layers, 55 leaves) and on llama3.2-3b's (254):
               ``adamw_update`` with the kernels over the whole tree, as
               the train step calls it, against the plain version leaf by
               leaf from the same start (one ulp of bf16, 1e-6 of fp32),
               and again bit for bit; ``adamw_update``
               timed with the kernels and with the plain version, the
               norm's kernels alone, ``torch._fused_adamw_`` (timed only)
               and the bound, 24 bytes a bf16 parameter with fp32
               moments at 3.35 TB/s;
 25. launch-train — llama3.2-3b at full width and depth trained through
               ``repro_torch.launch.train``'s placement code on a (1, 1)
               NCCL mesh: parameters, AdamW moments and batches are
               DTensors, the flash kernels run on each rank's local
               shards through ``local_map``. 1 warm-up and 3 timed steps
               on the batches of phase 12; launch counts set to 0 before
               and read after; losses and grad norms equal the unplaced
               steps' bit for bit (phase 12's, or the same steps run
               here when the train group is not run); the same placed
               steps again with the plain AdamW update (the step before
               the AdamW kernels): no AdamW kernel launched, the first
               loss equal and the first grad norm within 1e-6 relative
               of the kernels' steps; then the plain update with the
               kernels' grad norms replayed into it, its losses equal
               to the kernels' bit for bit;
 26. launch-roofline — the host's cost of one kernel launch (a stream of
               tiny ops timed with the host clock and CUDA events), then
               the dry-run's analyzer on the same cell (fake tensors, a
               one-rank fake mesh, the H100 model): its roofline terms
               beside the measured step, the compute and memory terms
               each at most the measured step;
 27. gates   — the caching engine's seven CI gates
               (``tools/smoke_torch.py``: artifact_counters, bitmap_prune,
               mqo, trace, failover, chaos, audit) at their tools' sizes
               on ``backend="torch_device"`` through the CUDA simjoin
               kernels (launch counts set to 0 before each, read after),
               each again with ``impl="plain"`` on the card: every run's
               per-query matches and non-timing summary keys equal, and
               the chaos storm's schedule; failover and chaos again on
               the paper's PTF deployment (``smoke_torch.PTF``: 2.6 M
               cells, 8 nodes, eps 300, prune="block", hot replication
               of 2, the fullest node killed halfway), held the same way;
               then the four ``examples/*_torch.py`` mains on the card
               (train_lm for 20 steps; quickstart must launch the dense
               simjoin kernel, serve_lm the paged one) and ``python -m
               repro_torch.launch.serve`` at its defaults (reduced
               qwen1.5-0.5b, head dim 16; run in this process by
               ``runpy``), each with its launches; last,
               the flash forward and backward and the paged kernel at
               head dim 16 timed as in 21 and 22 (reduced heads 4 / 4,
               B 2 x S 4096; the launcher's batched decode call).
 28. mla     — latent attention's bf16 flash kernels at each (q/k,
               value) head-dim pair (192, 128): forward and backward
               against their plain versions on phase 7's and phase 11's
               bf16 edge cases, then at moonlight-16b-a3b's call in its
               cell (B 2 x S 8192, 16 / 16 heads, causal; backward bits
               equal run to run), timed with CUDA events beside the plain
               versions and the operations bound; then one training step
               of moonlight-16b-a3b as the cell cuts it (8 of 64 experts
               held, vocab 20,480; every width, 27 layers) at that batch
               from the raw-array pipeline, its flash launches held to 2
               a layer forward (remat) and 1 backward.

``--phases`` runs some groups of these (join: 2-6, attn: 7-10, train:
11-14, moe: 15-18, ssm: 19, jamba: 20, hubert: 21, nemotron: 22, archs:
23, adamw: 24, launch: 25-26, gates: 27, mla: 28; the build and device
lines always); the default is all of them.

Every training phase (12, 18, 19, 21, 25) counts the AdamW kernels'
launches beside the attention kernels' and holds them to the launches
of one kernel update a step.

Prints the kernels' JSON record (each kernel's row also gives its
launches in phase 12 and every phase from 15 on under
``phase_launches``, the adamw row's ``launches`` those of phase 18, and
its replays at model shapes under ``shapes``) and the card's name and
power limit on the two lines before the last, and ``{"ok": true,
"device": ...}`` last.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.arrayio.catalog import FileReader, build_catalog  # noqa: E402
from repro_torch.arrayio.generator import (make_geo_files,  # noqa: E402
                                           make_ptf_files)
from repro_torch.core.cluster import (RawArrayCluster,  # noqa: E402
                                      workload_summary)
from repro_torch.core.workload import geo_workload, ptf2_workload  # noqa: E402
from repro_torch.kernels._build import build_all  # noqa: E402
from repro_torch.kernels.adamw import adamw as kadamw  # noqa: E402
from repro_torch.kernels.simjoin import ops, prune, simjoin  # noqa: E402
from repro_torch.kernels.simjoin.ref import count_pairs_ref  # noqa: E402
from repro_torch.configs import get as get_config  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import (RawArrayTokenPipeline,  # noqa: E402
                                       make_token_corpus)
from repro_torch.kernels.flash_attention import \
    flash_attention as flash  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_ref)
from repro_torch.kernels.paged_attention import \
    paged_attention as paged  # noqa: E402
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_ref  # noqa: E402
from repro_torch.launch.input_specs import batch_shape  # noqa: E402
from repro_torch.launch.serve import synth_requests  # noqa: E402
from repro_torch.models import attention as model_attention  # noqa: E402
from repro_torch.models import moe as model_moe  # noqa: E402
from repro_torch.models import ssm as model_ssm  # noqa: E402
from repro_torch.models.model import (decode_step, forward,  # noqa: E402
                                      init_decode_state, init_params)
from repro_torch.serve.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serve.serve_step import make_prefill_step  # noqa: E402
from repro_torch.train.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                          latest_checkpoint,
                                          restore_checkpoint)
from repro_torch.train.optimizer import (  # noqa: E402
    OptimizerConfig, adamw_init, adamw_update, step_scalars, sum_squares,
    update_leaf)
from repro_torch.train.train_step import (  # noqa: E402
    loss_fn, make_train_step, reference_decay_mask, value_and_grad)
from repro_torch.train.tree import leaves, named_leaves, tree_map  # noqa: E402

# The phases in groups, in the order they run; ``--phases`` picks some.
PHASE_GROUPS = ("join", "attn", "train", "moe", "ssm", "jamba", "hubert",
                "nemotron", "archs", "adamw", "launch", "gates", "mla")
N_NODES = 8
KERNEL_SRC = "src/repro_torch/kernels/simjoin/simjoin.cu"
SOURCES = {
    "flash_attention_fwd":
        "src/repro_torch/kernels/flash_attention/flash_attention.cu",
    "flash_attention_bwd":
        "src/repro_torch/kernels/flash_attention/flash_attention_bwd.cu",
    "paged_attention":
        "src/repro_torch/kernels/paged_attention/paged_attention.cu",
}
REPLACES = {
    "simjoin_block_counts": "src/repro/kernels/simjoin/simjoin.py:73",
    "simjoin_pruned_block_counts": "src/repro/kernels/simjoin/simjoin.py:108",
    "flash_attention_fwd":
        "src/repro/kernels/flash_attention/flash_attention.py:61",
    "paged_attention":
        "src/repro/kernels/paged_attention/paged_attention.py:71",
    # No Pallas backward: the reference's custom VJP in plain JAX.
    "flash_attention_bwd": "src/repro/models/attention.py:142",
}
# Attention bounds, H100 SXM data sheet (NVIDIA, dense, 700 W): 989 TFLOP/s
# bf16 on the tensor cores, 3.35 TB/s HBM3.
BF16_FLOPS_PER_S = 989e12
# The kernels' times before their redesign for Hopper, as PERF.md §6
# records them (an H100 80GB HBM3 at 700 W), quoted in the replay log
# lines beside this run's; the kernels JSON line holds only this run's
# numbers, and its "earlier" key points to PERF.md.
EARLIER = {"flash_attention_fwd": "8.4915 ms before the redesign (fp32 on "
                                  "the CUDA cores)",
           "paged_attention": "0.0738 ms before the redesign (one CTA per "
                              "(request, kv head))",
           "simjoin_block_counts": "0.0468 ms before the redesign (one CTA "
                                   "per block pair, int32, back to back)",
           "simjoin_pruned_block_counts": "0.3185 ms before the redesign "
                                          "(one CTA per row, int32, a "
                                          "device sync per launch, back to "
                                          "back)",
           "flash_attention_bwd": "4.1810 ms in a CUDA graph before the "
                                  "redesign (mma.sync, four warps a CTA)"}
# The serving slice (the repo's llama3.2-3b config at full size).
ARCH = "llama3.2-3b"
PREFILL_B, PREFILL_S = 2, 4096
SERVE = dict(slots=4, max_len=512, page_size=16, policy="cost")
# 4 requests (cut from 8 to keep the script inside its time limit with
# the MoE and SSM phases).
SERVE_REQUESTS, SYS_LEN, USER_LEN, NEW_TOKENS = 4, 192, 64, 16
# The prompt-replay call whose paged inputs are kept (slot 0's first
# prompt, the last position of the re-run replay window 128-159).
REPLAY_PROBE_POS = (SYS_LEN + USER_LEN) // 2 + 31
# Logit bounds, kernels against plain versions through the whole bf16
# model at full depth. Both sides compute attention in fp32 and round its
# output to bf16; they differ only in the order of fp32 sums, and the 28
# layers amplify the rare one-ulp flips of a bf16 output. The prefill
# phase prints that floor in every run: the plain step with naive
# attention against the plain step with blockwise attention, two
# formulations of the same function with no kernel in either (PERF.md
# §6). The bounds sit above the floor: relative L2 error of the
# logits (their rms is about 1) and largest absolute error.
MODEL_REL_L2 = 3e-2
MODEL_MAX_ABS = 0.2
# The bound's rates, H100 SXM data sheet at 700 W: the 67 TFLOP/s
# float32 CUDA-core peak (128 lanes per SM, an FMA
# counted as 2 operations) bounds any 32-bit operation rate of the CUDA
# cores from above, int32 included (64 INT32 lanes per SM, plus IMAD on
# the float32 lanes), so ops / 67e12 is a least time. 3.35 TB/s HBM3.
OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# The training slice: the same config at full width and depth, B x S
# tokens a step from the raw-array token pipeline (documents of up to
# S + 1 tokens, so every position has a label), TRAIN_STEPS timed steps.
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 4096, 4
TRAIN_SAMPLES, TRAIN_FILES, TRAIN_HOSTS = 8, 8, 4
TRAIN_HOST_BUDGET = 64 << 20
# The resume check's reduced size (S stays TRAIN_S, so "auto" attention
# takes the kernels).
RESUME = dict(d_model=512, n_periods=2, vocab=512)
# The backward kernels against attention_bwd_ref on the same (out, lse),
# relative to each gradient's largest magnitude: both sum in fp32 (1e-4
# for the order of the sums) and round once to the inputs' dtype (a bf16
# rounding step is 2^-8 of a value). Through autograd of the model's
# blockwise path the forwards differ as well (the bf16 kernel rounds P to
# bf16 for its P V product): the bf16 slack of the CPU tests, 5e-2.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
AUTOGRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# The first training step through the kernels against the same step on
# the plain versions, at full depth in bf16: the loss, the global grad
# norm, and every leaf's gradient by relative L2 error. The two steps
# differ where the prefill's logits do (up to the 3e-2 relative L2 bound
# above), carried back through 28 layers; a wiring fault (a missing GQA
# sum, a wrong scale, a dropped padded row) gives errors of order 1. The
# run prints the floor beside them: the plain step with the backward of
# attention_bwd_ref against the plain step with autograd through
# attention_ref, which share their forward.
# The unplaced train phase's timed steps (losses, grad norms, median
# step), which the launch-train phase holds the mesh-placed steps to.
TRAIN_RUN: dict = {}
TRAIN_LOSS_REL = 1e-3
TRAIN_GNORM_REL = 3e-2
TRAIN_LEAF_REL_L2 = 0.1


def cell_pair_ops(d: int) -> int:
    """int32 operations one cell pair needs: per dimension a subtraction,
    an absolute value and an addition (into the distance, the last one
    into the count), plus the ``<= eps`` comparison."""
    return 3 * d + 1

# The GEO constants (BENCH_kernels.json, geo_workload_pruning): identical
# in every prune mode and on every backend of the reference.
GEO_MATCHES = 100126
GEO_TOTAL = 3548
GEO_EVALUATED = {"dense": 3548, "block": 1122, "bitmap": 1084, "auto": 1084}
GEO_KILLED = 38


def log(msg: str) -> None:
    """One progress line, flushed."""
    print(msg, flush=True)


def card_label() -> str:
    """``name, power.limit`` as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, warmed)."""
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


# ------------------------------------------------------------- kernels


def stack(sides, sentinel, dev):
    """Pad (n, d) host coordinate sets to one (k, d, N) int32 stack."""
    n = max(s.shape[0] for s in sides)
    n = -(-max(n, 1) // simjoin.BLOCK) * simjoin.BLOCK
    out = []
    for s in sides:
        cm = ops.pad_cm_np(s, sentinel)
        if cm.shape[1] < n:
            cm = np.pad(cm, ((0, 0), (0, n - cm.shape[1])),
                        constant_values=sentinel)
        out.append(cm)
    return torch.from_numpy(np.stack(out)).to(dev)


def check_dense(a_sides, b_sides, eps, same, dev):
    """Kernel vs plain per-block-pair grids on the card; returns the max
    absolute difference (must be 0)."""
    a = stack(a_sides, simjoin.SENTINEL, dev)
    b = stack(b_sides, -simjoin.SENTINEL, dev)
    got = simjoin.simjoin_block_counts(a, b, eps, same)
    want = simjoin.simjoin_block_counts_plain(a, b, eps, same)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if err or not torch.equal(got, want):
        raise AssertionError(f"dense kernel != plain: eps={eps} same={same} "
                             f"shape={tuple(a.shape)}x{tuple(b.shape)}")
    return err


def pair_stack(a_sorted, b_sorted, eps, same, dev):
    """Host-built pair lists padded to one power-of-two length."""
    lists = [prune.build_block_pairs(x, y, simjoin.BLOCK, eps, same)[0]
             for x, y in zip(a_sorted, b_sorted)]
    plen = prune.padded_pair_len(max(p.shape[0] for p in lists))
    return torch.from_numpy(np.stack([prune.pad_pairs(p, plen)
                                      for p in lists])).to(dev)


def check_pruned(a_sides, b_sides, eps, same, dev):
    """Pair-list kernel vs plain on sorted sides; returns the max
    absolute difference (must be 0) and the number of pad rows seen."""
    a_s = [prune.spatial_sort(x) for x in a_sides]
    b_s = a_s if same else [prune.spatial_sort(x) for x in b_sides]
    pairs = pair_stack(a_s, b_s, eps, same, dev)
    if pairs.shape[1] == 0 or not bool((pairs[..., 2] != 0).any()):
        return 0, 0
    a = stack(a_s, simjoin.SENTINEL, dev)
    b = stack(b_s, -simjoin.SENTINEL, dev)
    got = simjoin.simjoin_pruned_block_counts(a, b, pairs, eps, same)
    want = simjoin.simjoin_pruned_block_counts_plain(a, b, pairs, eps, same)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if err or not torch.equal(got, want):
        raise AssertionError(f"pruned kernel != plain: eps={eps} "
                             f"same={same} pairs={tuple(pairs.shape)}")
    return err, int((pairs[..., 2] == 0).sum())


def clustered(rng, n, d, domain=153_064, spread=300):
    """Clustered integer coordinates in [0, domain]."""
    centers = rng.integers(spread, domain - spread, (6, d))
    pick = rng.integers(0, 6, n)
    return (centers[pick] + rng.integers(-spread, spread + 1, (n, d)))


def edge_cases(rng):
    """The walkers' edge cases: (label, a sides, b sides (one (n, d)
    array per task), pairs (k, P, 3), eps values, same). Task 0 of each range
    case lies within +-2^21 (the fp32 branch), task 1 reaches beyond it in
    the same launch (the int32 branch; at 2^29 a sum of four wraps past
    2^31, as int32 sums do in the plain version); the long
    lists change task and block_i inside every warp's range, in sorted and
    shuffled order, with pad rows mid-list (garbage indices, valid 0), a
    valid 2 row and, in self-joins, rows below the diagonal. The long
    cases hold some 20,000 rows, several per walking warp."""
    lim = simjoin.FP32_EXACT_LIMIT
    edge = np.array([-lim, -lim + 1, -1, 0, 1, lim - 1, lim])
    beyond = np.array([lim + 1, -lim - 1, (1 << 24) + 1, -(1 << 24) - 1,
                       1 << 29, -(1 << 29)])
    eps_all = (0, 1, 300, 1 << 22, (1 << 24) - 1, 1 << 24, (1 << 24) + 5,
               2 ** 31 - 1)

    def full_list(nab, nbb, same, shuffle):
        bi, bj = np.meshgrid(np.arange(nab), np.arange(nbb), indexing="ij")
        rows = np.stack([bi.ravel(), bj.ravel(), np.ones(bi.size, int)],
                        axis=1)
        if shuffle:
            rows = rows[rng.permutation(len(rows))]
        n_pad = max(2, len(rows) // 8)
        pads = np.stack([rng.integers(-9, 99999, n_pad),
                         rng.integers(-9, 99999, n_pad),
                         np.zeros(n_pad, int)], axis=1)
        at = np.sort(rng.choice(len(rows) + n_pad, n_pad, replace=False))
        out = np.insert(rows, at - np.arange(n_pad), pads, axis=0)
        out[rng.integers(0, len(out))] = [0, nbb - 1, 2]
        if same:
            out[rng.integers(0, len(out))] = [nab - 1, 0, 1]
        return out.astype(np.int32)

    cases = []
    for d in (1, 2, 3, 4):
        for same in (False, True):
            t0a = np.where(rng.random((300, d)) < 0.5,
                           rng.choice(edge, (300, d)),
                           rng.integers(-lim, lim + 1, (300, d)))
            t1a = t0a.copy()
            far = rng.random((300, d)) < 0.15
            t1a[far] = rng.choice(beyond, int(far.sum()))
            t0b, t1b = (t0a, t1a) if same else (
                rng.permutation(t0a), rng.permutation(t1a))
            pairs = np.stack([full_list(3, 3, same, True) for _ in range(2)])
            cases.append((f"d={d} same={same} +-2^21 and beyond",
                          [t0a, t1a], [t0b, t1b], pairs, eps_all, same))
    for shuffle in (False, True):
        for same in (False, True):
            sides = [clustered(rng, 6000, 3) for _ in range(8)]
            other = sides if same else [
                x + rng.integers(-150, 151, x.shape) for x in sides]
            lists = [full_list(47, 47, same, shuffle) for _ in range(8)]
            plen = max(len(x) for x in lists)
            pairs = np.stack([np.pad(x, ((0, plen - len(x)), (0, 0)))
                              for x in lists])
            cases.append((f"k=8 47x47 blocks same={same} "
                          f"{'shuffled' if shuffle else 'sorted'} list",
                          sides, other, pairs, (0, 300, 5000), same))
    return cases


def phase_edges(dev):
    """Both kernels against their plain versions on the edge cases;
    returns (cases, max |kernel - plain|)."""
    n_cases = 0
    max_err = 0
    for label, a_sides, b_sides, p_np, eps_all, same in edge_cases(
            np.random.default_rng(7)):
        a = stack(a_sides, simjoin.SENTINEL, dev)
        b = stack(b_sides, -simjoin.SENTINEL, dev)
        pairs = torch.from_numpy(p_np).to(dev)
        for eps in eps_all:
            want = {"dense": simjoin.simjoin_block_counts_plain(a, b, eps,
                                                                same),
                    "block": simjoin.simjoin_pruned_block_counts_plain(
                        a, b, pairs, eps, same)}
            got = {"dense": simjoin.simjoin_block_counts(a, b, eps, same),
                   "block": simjoin.simjoin_pruned_block_counts(
                       a, b, pairs, eps, same)}
            torch.cuda.synchronize()
            for kind in ("dense", "block"):
                err = int((got[kind].long() - want[kind].long()).abs().max())
                if err or not torch.equal(got[kind], want[kind]):
                    raise AssertionError(
                        f"edge case {label}: {kind} eps={eps} != plain "
                        f"(max abs err {err})")
                max_err = max(max_err, err)
            n_cases += 1
    return n_cases, max_err


def phase_kernels(dev):
    """Exact kernel-vs-plain sweep, the walker's edge cases, and kernel
    times at one large shape."""
    rng = np.random.default_rng(0)
    max_err = {"simjoin_block_counts": 0, "simjoin_pruned_block_counts": 0}
    pad_rows = 0
    cases = 0
    sizes = [(1, 1), (7, 13), (128, 128), (130, 255), (300, 41), (1024, 77),
             (1000, 1000)]
    for d in (2, 3):
        for n, m in sizes:
            for maker in ("small", "wide", "clustered"):
                def gen(k):
                    if maker == "small":
                        return rng.integers(0, 60, (k, d))
                    if maker == "wide":
                        return rng.integers(0, 153_065, (k, d))
                    return clustered(rng, k, d)
                a, b = gen(n), gen(m)
                for eps in (0, 1, 300):
                    for same in (False, True):
                        bb = a if same else b
                        e = check_dense([a], [bb], eps, same, dev)
                        max_err["simjoin_block_counts"] = max(
                            max_err["simjoin_block_counts"], e)
                        e, pr = check_pruned([a], [bb], eps, same, dev)
                        max_err["simjoin_pruned_block_counts"] = max(
                            max_err["simjoin_pruned_block_counts"], e)
                        pad_rows += pr
                        cases += 1
    # eps = 0 over duplicated cells, and batched k > 1 stacks.
    dup = np.repeat(np.array([[10, 10, 10], [10, 10, 10], [99, 1, 5]]),
                    100, axis=0)
    check_dense([dup], [dup], 0, True, dev)
    check_pruned([dup], [dup], 0, True, dev)
    for same in (False, True):
        a_sides = [clustered(rng, int(rng.integers(1, 900)), 3)
                   for _ in range(5)]
        b_sides = a_sides if same else [clustered(rng, int(rng.integers(
            1, 900)), 3) for _ in range(5)]
        check_dense(a_sides, b_sides, 300, same, dev)
        _, pr = check_pruned(a_sides, b_sides, 300, same, dev)
        pad_rows += pr
    if pad_rows == 0:
        raise AssertionError("the sweep never produced a valid == 0 row")
    # The oracle on a small input, end to end through ops.
    a = rng.integers(0, 400, (300, 3))
    b = rng.integers(0, 400, (200, 3))
    for same in (False, True):
        bb = a if same else b
        got = int(ops.count_similar_pairs(a, bb, 20, same, device=dev))
        want = int(count_pairs_ref(torch.from_numpy(a).to(dev),
                                   torch.from_numpy(bb).to(dev), 20, same))
        if got != want:
            raise AssertionError(f"ops vs oracle: {got} != {want}")
    log(f"kernels: {cases} sweep cases + duplicates + batched stacks, "
        f"{pad_rows} pad rows, kernel == plain bit for bit, "
        f"max_abs_err {max_err}")
    n_edge, edge_err = phase_edges(dev)
    for name in max_err:
        max_err[name] = max(max_err[name], edge_err)
    log(f"kernels: {n_edge} edge cases (d = 1..4, coordinates at +-2^21 and "
        f"beyond in one launch, eps 0 .. 2^31 - 1, lists changing task and "
        f"block_i inside each warp's range, sorted and shuffled, pad rows "
        f"mid-list), both kernels: kernel == plain bit for bit, "
        f"max_abs_err {edge_err}")
    # Times at one large shape: k=8 tasks of 8192 x 8192 cells, d=3.
    k, n, d = 8, 8192, 3
    a = torch.from_numpy(np.stack([ops.pad_cm_np(clustered(rng, n, d),
                                                 simjoin.SENTINEL)
                                   for _ in range(k)])).to(dev)
    b = torch.from_numpy(np.stack([ops.pad_cm_np(clustered(rng, n, d),
                                                 -simjoin.SENTINEL)
                                   for _ in range(k)])).to(dev)
    nb = n // simjoin.BLOCK
    bi, bj = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
    full = np.stack([bi.ravel(), bj.ravel(), np.ones(nb * nb, int)],
                    axis=1).astype(np.int32)
    pairs = torch.from_numpy(np.stack([full] * k)).to(dev)
    pairs_n = k * n * n
    bound = pairs_n * cell_pair_ops(d) / OPS_PER_S * 1e3
    def dense():
        return simjoin.simjoin_block_counts(a, b, 300, False)

    def listed():
        return simjoin.simjoin_pruned_block_counts(a, b, pairs, 300, False)
    dm, dg = cuda_ms(dense), graph_ms(dense)
    pm, pg = cuda_ms(listed), graph_ms(listed)
    log(f"kernels: k={k} Na=Nb={n} d={d} ({pairs_n} cell pairs): dense "
        f"{dm:.4f} ms back to back ({dg:.4f} ms in a CUDA graph) = "
        f"{pairs_n / dg * 1e3:.4e} cell pairs/s = {bound / dg:.4f} of its "
        f"{bound:.6f} ms bound; pair-list (all {nb * nb} block pairs) "
        f"{pm:.4f} ms ({pg:.4f} ms in a graph) = {bound / pg:.4f} of the "
        f"bound, {pg / dg:.4f} x dense [{card_label()}]")
    return max_err


# ------------------------------------------------------------ workloads


def make_cluster(catalog, data, budget_frac, **kw):
    """The port's cluster over ``catalog`` with a per-node budget of
    dataset bytes / ``budget_frac`` / N_NODES."""
    total = sum(f.n_cells * f.cell_bytes for f in catalog.files)
    return RawArrayCluster(catalog, FileReader(catalog, data), N_NODES,
                           total // budget_frac // N_NODES, policy="cost",
                           min_cells=8192, backend="torch_device",
                           device="cuda", **kw)


def phase_geo(root):
    """The GEO workload of the reference's kernel bench under every prune
    mode, held to its constants."""
    files = make_geo_files(n_files=4, n_seeds=300, clones_per_seed=40,
                           seed=11)
    catalog, data = build_catalog(files, str(root / "geo"), "csv",
                                  n_nodes=N_NODES)
    queries = geo_workload(catalog.domain, eps=500, range_frac=0.5)
    for mode in ("dense", "block", "bitmap", "auto"):
        t0 = time.perf_counter()
        cluster = make_cluster(catalog, data, 8, prune=mode)
        executed = cluster.run_workload(queries)
        s = workload_summary(executed)
        matches = sum(e.matches or 0 for e in executed)
        killed = s.get("block_pairs_bitmap_killed")
        log(f"geo[{mode}]: matches {matches}, block pairs "
            f"{s['block_pairs_evaluated']:.0f}/{s['block_pairs_total']:.0f}"
            f", bitmap killed {killed}, "
            f"{time.perf_counter() - t0:.2f} s wall")
        if matches != GEO_MATCHES:
            raise AssertionError(f"geo[{mode}] matches {matches}")
        if s["block_pairs_total"] != GEO_TOTAL:
            raise AssertionError(f"geo[{mode}] total {s}")
        if s["block_pairs_evaluated"] != GEO_EVALUATED[mode]:
            raise AssertionError(f"geo[{mode}] evaluated {s}")
        if mode in ("bitmap", "auto") and killed != GEO_KILLED:
            raise AssertionError(f"geo[{mode}] killed {killed}")


class BatchRecorder:
    """Wraps an executor's ``dispatch`` to keep the largest dense and
    pair-list batch (by cell pairs) of a run for replay, and brackets
    each dispatch with CUDA events so the run's device-busy time (kernel
    plus per-task reduction) can be summed afterwards."""

    def __init__(self, executor):
        self.largest = {}
        self.events = []
        self._dispatch = executor.dispatch
        executor.dispatch = self

    def busy_s(self) -> float:
        """Seconds the card spent inside dispatched work (synchronizes)."""
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3

    def __call__(self, batch, eps, arrays=None):
        """Dispatch, then remember the batch if it is the largest yet."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self._dispatch(batch, eps, arrays=arrays)
        end.record()
        self.events.append((start, end))
        kind = batch.fn_key[0]
        if kind == "dense":
            k, _, na = arrays[0].shape
            work = k * na * arrays[1].shape[2]
        else:
            work = int((arrays[2][..., 2] != 0).sum()) * simjoin.BLOCK ** 2
        if work > self.largest.get(kind, (0,))[0]:
            self.largest[kind] = (work, arrays, int(eps), batch.same)
        return out


def non_timing(summary):
    """Summary keys that are not measured timings (``*_s``,
    ``measured_*``)."""
    return {k: v for k, v in summary.items()
            if not k.endswith("_s") and not k.startswith("measured_")}


class SharedBitmapStage:
    """The bitmap stage's two host functions, ``prune.build_bitmaps`` and
    ``prune.refine_block_pairs``, memoized by the bytes of their inputs
    while installed (``with``). A PTF run and its plain replay prepare the
    same chunks with the same host code, so the replay takes the first
    run's bitmaps and refined pair lists instead of building them again
    (the stage is nearly all of the main path's wall). Nothing else
    changes: each run still goes through its own artifact cache (so its
    hits, misses and killed pairs are its own), and the join counts come
    from the kernels or their plain versions on the card."""

    def __init__(self):
        self.results = {}
        # id(bitmap list) -> (its key, the list): the list stays alive,
        # so its id names it while the stage is installed.
        self.keys = {}
        self.hits = 0
        self._real = (prune.build_bitmaps, prune.refine_block_pairs)

    @staticmethod
    def digest(arr):
        """A key for an array's dtype, shape and bytes."""
        a = np.ascontiguousarray(arr)
        return (a.dtype.str, a.shape,
                hashlib.blake2b(a.tobytes(), digest_size=16).hexdigest())

    def _memo(self, key, compute):
        if key in self.results:
            self.hits += 1
        else:
            self.results[key] = compute()
        return self.results[key]

    def build_bitmaps(self, coords, block, scale):
        """``prune.build_bitmaps``, memoized."""
        key = ("bitmaps", self.digest(coords), int(block), int(scale))
        out = self._memo(key, lambda: self._real[0](coords, block, scale))
        self.keys[id(out)] = (key, out)
        return out

    def refine_block_pairs(self, pairs, bm_a, bm_b, eps, scale):
        """``prune.refine_block_pairs``, memoized (on bitmaps this stage
        built; any other input is refined afresh)."""
        ka, kb = self.keys.get(id(bm_a)), self.keys.get(id(bm_b))
        if ka is None or kb is None:
            return self._real[1](pairs, bm_a, bm_b, eps, scale)
        key = ("refined", self.digest(pairs), ka[0], kb[0], int(eps),
               int(scale))
        refined, killed = self._memo(key, lambda: self._real[1](
            pairs, bm_a, bm_b, eps, scale))
        return refined.copy(), killed

    def __enter__(self):
        prune.build_bitmaps = self.build_bitmaps
        prune.refine_block_pairs = self.refine_block_pairs
        return self

    def __exit__(self, *exc):
        prune.build_bitmaps, prune.refine_block_pairs = self._real


def phase_ptf(root, tag, cells, prune_mode, main_path):
    """One PTF run through the kernels (launch counts set to 0 just
    before and read just after), then the whole workload again through
    the plain versions on the card: per-query matches and non-timing
    summary keys must agree. The replay takes the first run's bitmap
    stage (:class:`SharedBitmapStage`). On the ``main_path`` run every
    kernel must have launched."""
    t0 = time.perf_counter()
    files = make_ptf_files(n_files=32, cells_per_file_mean=cells,
                           skew=1.1, seed=21)
    catalog, data = build_catalog(files, str(root / tag), "hdf5",
                                  n_nodes=N_NODES)
    queries = ptf2_workload(catalog.domain, n_queries=10, eps=300)
    n_cells = sum(f.n_cells for f in catalog.files)
    n_bytes = sum(f.n_cells * f.cell_bytes for f in catalog.files)
    t_data = time.perf_counter() - t0
    log(f"{tag}: {len(files)} files, {n_cells} cells, {n_bytes} bytes, "
        f"generate + write {t_data:.2f} s")

    cluster = make_cluster(catalog, data, 4, prune=prune_mode)
    recorder = BatchRecorder(cluster.executor)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in simjoin.LAUNCHES:
        simjoin.LAUNCHES[name] = 0
    shared = SharedBitmapStage()
    t0 = time.perf_counter()
    with shared:
        executed = cluster.run_workload(queries)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = dict(simjoin.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    busy = recorder.busy_s()
    summary = workload_summary(executed)
    if main_path and any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    evaluated_pairs = summary["block_pairs_evaluated"] * simjoin.BLOCK ** 2
    busiest_pairs = summary["compute_time_s"] * cluster.cost.cell_pairs_per_sec
    label = card_label()
    log(f"{tag}[kernel]: device busy {busy:.6f} s of {t_run:.3f} s "
        f"run_workload wall = idle share {1 - busy / t_run:.6f}, "
        f"{len(recorder.events)} dispatches [{card_label()}]")
    log(f"{tag}[kernel]: run_workload {t_run:.3f} s wall, launches "
        f"{launches}, per-query matches "
        f"{[e.matches for e in executed]} [{label}]")
    log(f"{tag}[kernel]: planner (opt_time_s) {summary['opt_time_s']:.3f} s, "
        f"prep_s {summary['prep_s']:.3f}, dispatch_s "
        f"{summary['dispatch_s']:.3f}, measured_compute_s "
        f"{summary['measured_compute_s']:.3f}, measured_net_s "
        f"{summary['measured_net_s']:.3f}, bitmap_build_s "
        f"{summary.get('bitmap_build_s', 0.0):.3f} [{label}]")
    log(f"{tag}[kernel]: block pairs {summary['block_pairs_evaluated']:.0f}/"
        f"{summary['block_pairs_total']:.0f} = {evaluated_pairs:.0f} cell "
        f"pairs on the card; busiest-node dense work {busiest_pairs:.0f} "
        f"cell pairs; max_memory_allocated {peak} bytes [{label}]")
    log(f"{tag}[kernel]: device_stats {cluster.backend.device_stats}")
    log(f"{tag}[kernel]: summary {json.dumps(summary)}")

    # The same workload with the plain versions on the card.
    plain = make_cluster(catalog, data, 4, prune=prune_mode, impl="plain")
    hits = shared.hits
    t0 = time.perf_counter()
    with shared:
        plain_exec = [plain.run_query(q) for q in queries]
    torch.cuda.synchronize()
    n = len(plain_exec)
    got = [e.matches for e in executed]
    want = [e.matches for e in plain_exec]
    s_kernel = non_timing(summary)
    s_plain = non_timing(workload_summary(plain_exec))
    log(f"{tag}[plain]: all {n} queries in {time.perf_counter() - t0:.3f} "
        f"s wall ({shared.hits - hits} bitmap-stage results taken from "
        f"the kernel run), matches {want} [{label}]")
    if got != want:
        raise AssertionError(f"{tag} per-query matches differ: {got} vs "
                             f"{want}")
    if s_kernel != s_plain:
        raise AssertionError(f"{tag} summaries differ: {s_kernel} vs "
                             f"{s_plain}")
    log(f"{tag}: kernel run == plain run on {n} queries (matches and "
        f"{len(s_kernel)} non-timing summary keys)")
    return launches, recorder.largest, evaluated_pairs


def replay(largest):
    """The main path's largest batch per kernel through kernel and plain
    version: exact comparison, times (back to back from Python, as the
    path launches it, and in a CUDA graph of 100 launches, the card's time
    alone), and the bound."""
    rows = []
    label = card_label()
    for kind, name in (("dense", "simjoin_block_counts"),
                       ("block", "simjoin_pruned_block_counts")):
        work, arrays, eps, same = largest[kind]
        if kind == "dense":
            def kern():
                return simjoin.simjoin_block_counts(*arrays, eps, same)

            def plain():
                return simjoin.simjoin_block_counts_plain(*arrays, eps,
                                                          same)
        else:
            def kern():
                return simjoin.simjoin_pruned_block_counts(*arrays, eps,
                                                           same)

            def plain():
                return simjoin.simjoin_pruned_block_counts_plain(
                    *arrays, eps, same)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if err or not torch.equal(got, want):
            raise AssertionError(f"{name} != plain at the main-path shape")
        ms = cuda_ms(kern, reps=100)
        in_graph_ms = graph_ms(kern)
        plain_ms = cuda_ms(plain, reps=3)
        d = arrays[0].shape[1]
        ops_count = work * cell_pair_ops(d)
        bytes_moved = sum(x.nbytes for x in arrays) + got.nbytes
        ops_ms = ops_count / OPS_PER_S * 1e3
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        shapes = [tuple(x.shape) for x in arrays]
        log(f"replay[{name}]: shapes {shapes}, eps {eps}, same {same}, "
            f"{work} cell pairs, kernel {ms:.4f} ms per launch back to back "
            f"from Python, {in_graph_ms:.4f} ms in a CUDA graph, plain "
            f"{plain_ms:.4f} ms, bound {bound:.6f} ms = "
            f"{bound / in_graph_ms:.4f} of the graph time; earlier "
            f"{EARLIER[name]} [{label}]")
        rows.append({"name": name, "ms": ms, "graph_ms": in_graph_ms,
                     "plain_ms": plain_ms, "max_abs_err": err,
                     "bound_ms": bound,
                     "bound_by": ("operations" if ops_ms >= bytes_ms
                                  else "bytes")})
    return rows


# ------------------------------------------------------ attention slice


def device_activity(prof):
    """What the card did during a profiled window: (busy seconds, the
    number of device events, device seconds by event name). Busy time is
    the union of the device activity intervals the profiler recorded
    (kernels, copies, sets; not the device-side copies of
    ``record_function`` ranges); None when it recorded none."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e6
    total, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if e > end:
            total += e - max(s, end)
            end = e
    return (total / 1e6 if events else None), len(events), by_name


def profiled(fn):
    """Run ``fn()`` once under ``torch.profiler``; returns (result, wall
    seconds of the profiled run, ``device_activity``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, device_activity(prof)


def share(activity, wall, profiled_wall):
    """Log fragment: device busy time against the unprofiled ``wall`` of
    the same work (busy and idle share) and against the profiled run's,
    the number of device events and the three names with the most device
    time."""
    busy, n_events, by_name = activity
    if busy is None:
        return "device busy not measured (the profiler saw no device time)"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return (f"device busy {busy:.6f} s; unprofiled wall {wall:.6f} s: busy "
            f"share {busy / wall:.6f}, idle share {1 - busy / wall:.6f} "
            f"(profiled wall {profiled_wall:.6f} s, busy share "
            f"{busy / profiled_wall:.6f}); {n_events} device events; most "
            f"device time: " + "; ".join(f"{name[:60]} {sec:.6f} s"
                                         for name, sec in top))


def kernel_time(activity, marker, per=1):
    """Log fragment: the device seconds of the kernels whose name holds
    ``marker`` in a profiled window, their share of the device's busy
    time, and milliseconds per ``per`` (a step)."""
    busy, _, by_name = activity
    if busy is None:
        return f"{marker}: not measured"
    sec = sum(t for name, t in by_name.items() if marker in name)
    return (f"{marker} {sec:.6f} s = {sec / busy:.6f} of device busy time, "
            f"{1e3 * sec / per:.4f} ms per step")


def close(got, want, atol, rtol, what):
    """Max |got - want| after checking |got - want| <= atol + rtol |want|."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if not torch.isfinite(g).all() or \
            bool(((g - w).abs() > atol + rtol * w.abs()).any()):
        raise AssertionError(f"{what}: max abs err {err} beyond atol "
                             f"{atol} rtol {rtol}")
    return err


def logit_errors(got, want):
    """(max |got - want|, ||got - want||_2 / ||want||_2) of two logit
    tensors."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max()), float((g - w).norm() / w.norm())


def close_logits(got, want, what):
    """``logit_errors`` after checking them against the model-level
    bounds (MODEL_MAX_ABS, MODEL_REL_L2) and the logits for finiteness."""
    err, rel = logit_errors(got, want)
    if not torch.isfinite(got).all() or err > MODEL_MAX_ABS or \
            rel > MODEL_REL_L2:
        raise AssertionError(f"{what}: max abs err {err} (bound "
                             f"{MODEL_MAX_ABS}), relative L2 err {rel} "
                             f"(bound {MODEL_REL_L2})")
    return err, rel


def randn(rng, shape, dtype, dev):
    """Seeded normal draws as a card tensor of ``dtype``."""
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        dev, dtype)


# The bf16 forward kernels' edge cases (B, Sq, Sk, H, Hk, causal,
# q_offset), at every head dim and (q/k, value) pair: causal GQA, ragged
# Sk without a mask past the diagonal, q_offset.
FWD_EDGES = ((2, 256, 256, 8, 2, True, 0), (1, 130, 200, 3, 1, False, 0),
             (1, 64, 256, 2, 2, True, 192))


def fwd_case(rng, dev, b, sq, sk, h, hk, d, causal, q_offset, dv=None):
    """The bf16 forward kernel at q/k head dim ``d`` and value head dim
    ``dv`` (``d`` by default), heads-first, against ``attention_ref``;
    returns the max abs error."""
    dv = d if dv is None else dv
    qt, kt, vt = (randn(rng, (b, n, hh, w), torch.bfloat16, dev)
                  .transpose(1, 2).contiguous()
                  for n, hh, w in ((sq, h, d), (sk, hk, d), (sk, hk, dv)))
    got = flash.flash_attention_fwd(qt, kt, vt, causal=causal, bq=1, bk=1,
                                    q_offset=q_offset)
    want = attention_ref(qt, kt, vt, causal=causal, q_offset=q_offset)
    return close(got, want, 2e-2, 2e-2, f"flash bf16 D{d} DV{dv} Sq{sq} "
                 f"Sk{sk} H{h}/{hk} causal={causal} q_offset={q_offset}")

def phase_attention_kernels(dev):
    """Both attention kernels against their plain versions on the sweeps
    of the reference's kernel tests and at the slice's shapes."""
    rng = np.random.default_rng(12)
    err = {"flash_attention_fwd": 0.0, "paged_attention": 0.0}
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    cases = 0

    def flash_case(b, sq, sk, h, hk, d, dtype, causal, bq=128, bk=128,
                   tol=None):
        q = randn(rng, (b, sq, h, d), dtype, dev)
        k = randn(rng, (b, sk, hk, d), dtype, dev)
        v = randn(rng, (b, sk, hk, d), dtype, dev)
        got = flash_ops.flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
        want = flash_ops.flash_attention(q, k, v, causal=causal, bq=bq,
                                         bk=bk, impl="plain")
        t = tols[dtype] if tol is None else tol
        e = close(got, want, t, t, f"flash B{b} Sq{sq} Sk{sk} H{h}/{hk} D{d} "
                  f"{dtype} causal={causal}")
        err["flash_attention_fwd"] = max(err["flash_attention_fwd"], e)
        return q, k, v, got

    for dtype in (torch.float32, torch.bfloat16):
        for sq, causal in ((128, True), (256, True), (130, True),
                           (256, False), (384, True)):
            flash_case(2, sq, sq if causal else 256, 4, 4, 64, dtype, causal)
            cases += 1
    for h, hk in ((8, 8), (8, 2), (4, 1)):
        flash_case(1, 128, 128, h, hk, 32, torch.float32, True)
        cases += 1
    q, k, v, a = flash_case(1, 256, 256, 2, 2, 64, torch.float32, True)
    b = flash_ops.flash_attention(q, k, v, causal=True, bq=64, bk=32)
    close(b, a, 1e-5, 1e-5, "flash block-size invariance")
    for dtype in (torch.float32, torch.bfloat16):
        qt, kt, vt = (randn(rng, shape, dtype, dev) for shape in
                      ((1, 2, 64, 32), (1, 2, 256, 32), (1, 2, 256, 32)))
        got = flash.flash_attention_fwd(qt, kt, vt, causal=True, bq=64,
                                        bk=64, q_offset=192)
        want = attention_ref(qt, kt, vt, causal=True, q_offset=192)
        e = close(got, want, tols[dtype], tols[dtype], "flash q_offset=192")
        err["flash_attention_fwd"] = max(err["flash_attention_fwd"], e)
        cases += 2
    # The bf16 (wgmma) kernel at every head dim on FWD_EDGES (the
    # (q/k, value) pairs: phase 28).
    for d in flash.HEAD_DIMS:
        for b, sq, sk, h, hk, causal, off in FWD_EDGES:
            e = fwd_case(rng, dev, b, sq, sk, h, hk, d, causal, off)
            err["flash_attention_fwd"] = max(err["flash_attention_fwd"], e)
            cases += 1
    # The fp32 (CUDA-core) kernel at head dim 16, every reduced config's:
    # causal GQA, ragged non-causal Sk, q_offset.
    for b, sq, sk, h, hk, causal, off in (
            (2, 256, 256, 8, 2, True, 0), (1, 130, 200, 4, 4, False, 0),
            (1, 64, 256, 4, 1, True, 192)):
        qt, kt, vt = (randn(rng, (b, hh, n, 16), torch.float32, dev)
                      for n, hh in ((sq, h), (sk, hk), (sk, hk)))
        got = flash.flash_attention_fwd(qt, kt, vt, causal=causal, bq=1,
                                        bk=1, q_offset=off)
        want = attention_ref(qt, kt, vt, causal=causal, q_offset=off)
        e = close(got, want, 2e-5, 2e-5, f"flash fp32 D16 Sq{sq} Sk{sk} "
                  f"H{h}/{hk} causal={causal} q_offset={off}")
        err["flash_attention_fwd"] = max(err["flash_attention_fwd"], e)
        cases += 1
    cfg = get_config(ARCH)
    hd = cfg.resolved_head_dim
    flash_case(PREFILL_B, PREFILL_S, PREFILL_S, cfg.n_heads, cfg.n_kv_heads,
               hd, torch.bfloat16, True)
    cases += 1
    log(f"attn[flash]: {cases} sweep cases + block-size invariance, kernel "
        f"== plain, max_abs_err {err['flash_attention_fwd']}")

    cases = 0
    tols = {torch.float32: 2e-5, torch.bfloat16: 3e-2}

    def paged_case(b, h, hk, d, n_pages, ps, maxp, lens, dtype, table=None,
                   splits=(None,)):
        q = randn(rng, (b, h, d), dtype, dev)
        kp = randn(rng, (n_pages, ps, hk, d), dtype, dev)
        vp = randn(rng, (n_pages, ps, hk, d), dtype, dev)
        if table is None:
            table = rng.permutation(n_pages)[:b * maxp].reshape(b, maxp)
        table = torch.as_tensor(np.asarray(table, np.int32), device=dev)
        sl = torch.as_tensor(np.asarray(lens, np.int32), device=dev)
        want = paged.paged_attention(q, kp, vp, table, sl, impl="plain")
        for n in splits:
            # None: the wrapper's own count. A number: that count forced
            # through the launcher (the inputs are contiguous and the
            # table valid), each split at least 1 position.
            got = paged.paged_attention(q, kp, vp, table, sl) if n is None \
                else paged._launch(paged.LIBRARY.load(), q, kp, vp, table,
                                   sl, torch.empty_like(q), n, 1)
            e = close(got, want, tols[dtype], tols[dtype],
                      f"paged B{b} H{h}/{hk} D{d} PS{ps} MAXP{maxp} lens "
                      f"{lens} {dtype} splits={n}")
            err["paged_attention"] = max(err["paged_attention"], e)
        return got

    for ps, maxp in ((16, 4), (32, 2), (8, 8)):
        for h, hk in ((4, 4), (8, 2)):
            paged_case(3, h, hk, 32, 64, ps, maxp, [ps * maxp] * 3,
                       torch.float32)
            cases += 1
    for lens in ([1, 17, 40, 64], [0, 5, 0, 64], [64, 63, 33, 16]):
        paged_case(4, 4, 4, 32, 64, 16, 4, lens, torch.float32)
        cases += 1
    shared = paged_case(2, 4, 4, 32, 32, 16, 3, [48, 48], torch.float32,
                        table=[[5, 9, 11], [5, 9, 11]])
    paged_case(2, 4, 4, 64, 32, 16, 2, [32, 32], torch.bfloat16)
    cases += 2
    # The decode shape: the engine's slots over the page view of its
    # cache, at a spread of live lengths.
    slots, max_len = SERVE["slots"], SERVE["max_len"]
    ps = model_attention.page_size_for(max_len)
    n_pg = max_len // ps
    lens = np.linspace(0, max_len, slots).astype(int).tolist()
    paged_case(slots, cfg.n_heads, cfg.n_kv_heads, hd, slots * n_pg, ps,
               n_pg, lens, torch.bfloat16,
               table=np.arange(slots * n_pg).reshape(slots, n_pg))
    cases += 1
    # The two serving calls' shapes (B = 1 prompt replay, B = 4 batched
    # decode), in both dtypes, at every split count.
    every = (None,) + tuple(range(1, paged.MAX_SPLITS + 1))
    for dtype in (torch.float32, torch.bfloat16):
        paged_case(1, cfg.n_heads, cfg.n_kv_heads, hd, n_pg, ps, n_pg,
                   [REPLAY_PROBE_POS + 1], dtype, splits=every)
        paged_case(slots, cfg.n_heads, cfg.n_kv_heads, hd, slots * n_pg, ps,
                   n_pg, [271] * slots, dtype, splits=every)
        cases += 2
    # Head dims 16, 80 and 192 with a GQA group of 12 (two CTAs of query
    # heads a KV head), ragged lengths, every split count; and 16 at the
    # reduced configs' 4 query heads (qwen1.5-0.5b's MHA, llama's GQA 3).
    for d, h, hk in ((16, 24, 2), (80, 24, 2), (192, 24, 2), (16, 4, 4),
                     (16, 4, 1)):
        for dtype in (torch.float32, torch.bfloat16):
            paged_case(4, h, hk, d, 64, 16, 4, [0, 1, 33, 64], dtype,
                       splits=every)
            cases += 1
    q = randn(rng, (2, 4, 32), torch.float32, dev)
    q[1] = q[0]
    kp = randn(rng, (32, 16, 4, 32), torch.float32, dev)
    table = torch.tensor([[5, 9, 11], [5, 9, 11]], dtype=torch.int32,
                         device=dev)
    out = paged.paged_attention(q, kp, kp, table,
                                torch.tensor([48, 48], device=dev))
    if not torch.equal(out[0], out[1]):
        raise AssertionError("paged: shared prefix pages, equal queries, "
                             "unequal outputs")
    del shared
    log(f"attn[paged]: {cases} sweep cases (permuted tables, ragged "
        f"lengths, seq_len = 0, shared prefix pages; the serving shapes at "
        f"split counts {every}), kernel == plain, max_abs_err "
        f"{err['paged_attention']}")
    return err


def zero_launches():
    """Set every attention-kernel and AdamW-kernel launch count to 0."""
    for name in flash.LAUNCHES:
        flash.LAUNCHES[name] = 0
    paged.LAUNCHES["paged_attention"] = 0
    kadamw.LAUNCHES["adamw"] = 0


def step_launches():
    """The attention and AdamW kernels' launch counts since
    :func:`zero_launches`, as a train step's launches are held."""
    return {**flash.LAUNCHES, **kadamw.LAUNCHES}


def adamw_step_launches(params):
    """The AdamW kernels' launches in one kernel ``adamw_update`` of
    ``params`` with gradients in the parameters' dtypes and moments of
    one dtype: per batch of leaves of one dtype (at most the library's
    leaves a launch) two for the sums of squares and one for the update,
    and one for the scalars."""
    max_leaves = kadamw._limits(kadamw.LIBRARY.load())[0]
    dtypes = [p.dtype for p in leaves(params)]
    batches = sum(-(-dtypes.count(d) // max_leaves) for d in set(dtypes))
    return 3 * batches + 1


class StepRecorder:
    """Wraps a ``ServingEngine``'s decode step and prompt replay, and
    records every decode_step call: the slot of a replay step (None for a
    batched step), tokens, positions and the last position's logits, all
    left on the card (nothing here synchronizes); ``router`` (a
    ``RoutingRecorder``) is told each call's number. With ``probe_pos``,
    ``capture`` names the kind of the step under way when its paged call
    is to be kept by the probe of ``serve_check``: every batched step, and
    the first replay step of slot 0 at position ``probe_pos`` (counted on
    the host from the replay's start)."""

    def __init__(self, engine, router, probe_pos=None):
        self.calls = []
        self.router, self.probe_pos = router, probe_pos
        self.slot = None
        self.pos = 0
        self.capture = None
        self.kept = False
        self._decode = engine._decode
        self._prefill = engine._prefill_into_slot
        engine._decode = self
        engine._prefill_into_slot = self.prefill

    def prefill(self, state, slot, tokens, start):
        """Tag the replay steps of one admission with their slot."""
        self.slot, self.pos = slot, start
        try:
            return self._prefill(state, slot, tokens, start)
        finally:
            self.slot = None

    def __call__(self, params, tokens, state, pos):
        """One recorded decode step."""
        self.router.call = len(self.calls)
        if self.probe_pos is None:
            pass
        elif self.slot is None:
            self.capture = "batched"
        elif self.slot == 0 and self.pos == self.probe_pos and \
                not self.kept:
            self.capture, self.kept = "replay", True
        logits, state = self._decode(params, tokens, state, pos)
        self.capture = None
        self.pos += 1
        self.calls.append((self.slot, tokens.clone(), pos.clone(),
                           logits[:, -1].clone()))
        return logits, state


def step_window(params, cfg, dev, window):
    """Re-run recorded decode_step calls on a zeroed state of the
    engine's shape (the step's work depends on the positions, not on the
    cache's values): once to warm up, once timed, once profiled. Returns
    (wall, profiled wall, ``device_activity``)."""
    state = init_decode_state(cfg, SERVE["slots"], SERVE["max_len"],
                              device=dev)

    @torch.no_grad()
    def run():
        for slot, tok, pos in window:
            st = state if slot is None else [
                {k: t[slot:slot + 1] for k, t in layer.items()}
                for layer in state]
            decode_step(params, cfg, tok, st, pos)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, pwall, activity = profiled(run)
    return wall, pwall, activity


def serve_windows(params, cfg, dev, calls):
    """Two windows of the llama serving run's decode_step ``calls``,
    re-run for ms per step and the card's busy share: 32 prompt-replay
    steps of slot 0 from the middle of its first prompt, and the first 8
    batched decode steps (all slots active)."""
    label = card_label()
    mid = (SYS_LEN + USER_LEN) // 2
    replay_w = [(s, t, p) for s, t, p, _ in calls
                if s == 0 and mid <= int(p[0]) < mid + 32][:32]
    decode_w = [(s, t, p) for s, t, p, _ in calls if s is None][:8]
    for kind, window in (("prompt-replay", replay_w),
                         ("batched decode", decode_w)):
        wwall, pwall, activity = step_window(params, cfg, dev, window)
        log(f"serve: {len(window)} {kind} steps re-run: "
            f"{1e3 * wwall / len(window):.4f} ms per step; "
            f"{share(activity, wwall, pwall)}; "
            f"{kernel_time(activity, 'paged_split_kernel', len(window))} "
            f"[{label}]")


def capture(fn, n: int):
    """A warmed CUDA graph of ``n`` calls of ``fn()``."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(n):
                fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def graph_ms(fn, n: int = 100) -> float:
    """Milliseconds per call of ``fn()`` replayed from a CUDA graph of
    ``n`` calls (CUDA events around one replay, warmed): the card's time
    per launch without the host's launch cost between launches."""
    graph = capture(fn, n)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_kernel_ms(fn, n: int = 10):
    """Device milliseconds per launch by kernel name, and the number of
    launches the profiler recorded, from one replay of a CUDA graph of
    ``n`` calls of ``fn()`` under ``torch.profiler``: the mean over the
    recorded launches (the profiler can drop some launches of a graph
    replay). None when it recorded no device time."""
    graph = capture(fn, n)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        graph.replay()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total[e.name] = total.get(e.name, 0.0) + \
                (e.time_range.end - e.time_range.start) / 1e3
            count[e.name] = count.get(e.name, 0) + 1
    if not total:
        return None
    return {name: (total[name] / count[name], count[name]) for name in total}


def replay_paged(args, kind, label):
    """One kept serving call through the paged kernel: compared with the
    plain version and timed (graph, back to back, wrapper, plain, SDPA on
    the dense view), with its bound and the split count chosen."""
    q, kp, vp, table, sl = args
    dev = q.device
    got = paged.paged_attention(q, kp, vp, table, sl)
    want = paged_attention_ref(q, kp, vp, table, sl)
    err = close(got, want, 3e-2, 3e-2, f"paged replay ({kind})")
    lib = paged.LIBRARY.load()
    out = torch.empty_like(q)
    bsz, hq, dd = q.shape
    n_pg, ps = table.shape[1], kp.shape[1]
    hkv = kp.shape[2]
    splits = paged.split_count(bsz, hkv, n_pg * ps, dev)

    def launch(min_len=paged.MIN_SPLIT_LEN):
        paged._launch(lib, q, kp, vp, table, sl, out, splits, min_len)
    # Launched back to back from Python, as the path launches it (and as
    # the time before the redesign was taken); then the card's time per
    # launch alone, from a CUDA graph.
    ms = cuda_ms(launch, reps=100)
    in_graph_ms = graph_ms(launch)
    # The same launch with 64 positions per split at least, for the
    # record of MIN_SPLIT_LEN's choice.
    ms_64 = graph_ms(lambda: launch(64))
    wrapper_ms = cuda_ms(lambda: paged.paged_attention(q, kp, vp, table, sl),
                         reps=100)
    plain_ms = cuda_ms(lambda: paged_attention_ref(q, kp, vp, table, sl),
                       reps=10)
    # SDPA on the dense view of the pages this call reads (the table is
    # the engine's identity page view of its slot cache).
    pages = table.long().reshape(-1)
    kd = kp[pages].view(bsz, n_pg * ps, hkv, dd).transpose(1, 2).contiguous()
    vd = vp[pages].view(bsz, n_pg * ps, hkv, dd).transpose(1, 2).contiguous()
    mask = (torch.arange(n_pg * ps, device=dev)[None, :]
            < sl[:, None])[:, None, None, :]
    qd = q[:, :, None, :]
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True), reps=100)
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True)[:, :, 0]
    close(sdpa, want, 3e-2, 3e-2, "sdpa on the dense view")
    live = int(sl.clamp(min=0).sum())
    nbytes = (2 * live * hkv * dd * kp.element_size() + q.nbytes
              + out.nbytes + table.nbytes + sl.nbytes)
    flops = 4 * hq * dd * live
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"replay[paged_attention] {kind}: q {tuple(q.shape)} pages "
        f"{tuple(kp.shape)} table {tuple(table.shape)} seq_lens "
        f"{sl.tolist()} bf16, {splits} splits of at least "
        f"{paged.MIN_SPLIT_LEN} positions: kernel {ms:.4f} ms per launch "
        f"back to back from Python, {in_graph_ms:.4f} ms in a CUDA graph "
        f"({ms_64:.4f} ms with 64 positions per split at least; wrapper "
        f"with the table check {wrapper_ms:.4f} ms), plain {plain_ms:.4f} "
        f"ms, sdpa {lib_ms:.4f} ms, bound {max(ops_ms, bytes_ms):.6f} ms "
        f"({nbytes} bytes, {flops} flops); earlier {EARLIER['paged_attention']}"
        f" [{label}]")
    return dict(ms=ms, graph_ms=in_graph_ms, plain_ms=plain_ms,
                library_ms=lib_ms, max_abs_err=err, splits=splits,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def phase_attention_replay(dev, paged_args):
    """Flash at the prefill's shape and paged at both kept serving calls:
    kernel, plain and library times, and the bounds."""
    cfg = get_config(ARCH)
    hd = cfg.resolved_head_dim
    rng = np.random.default_rng(14)
    rows = {}
    label = card_label()
    # Flash at the prefill's shape, heads-first as the kernel takes it.
    b, s, h, hk = PREFILL_B, PREFILL_S, cfg.n_heads, cfg.n_kv_heads
    q = randn(rng, (b, h, s, hd), torch.bfloat16, dev)
    k = randn(rng, (b, hk, s, hd), torch.bfloat16, dev)
    v = randn(rng, (b, hk, s, hd), torch.bfloat16, dev)
    got = flash.flash_attention_fwd(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    err = close(got, want, 2e-2, 2e-2, "flash replay")
    ms = cuda_ms(lambda: flash.flash_attention_fwd(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=True), reps=3)
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    live_pairs = b * h * s * (s + 1) // 2
    flops = 4 * hd * live_pairs
    nbytes = (q.nbytes + k.nbytes + v.nbytes + got.nbytes)
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rows["flash_attention_fwd"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=err,
        bound_ms=max(ops_ms, bytes_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    log(f"replay[flash_attention_fwd]: q {tuple(q.shape)} k/v "
        f"{tuple(k.shape)} bf16 causal: kernel {ms:.4f} ms = "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {ms / lib_ms:.3f} x sdpa; plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms = "
        f"{flops / lib_ms / 1e9:.1f} TFLOP/s, bound "
        f"{max(ops_ms, bytes_ms):.6f} ms ({flops} flops, {nbytes} bytes); "
        f"earlier {EARLIER['flash_attention_fwd']} [{label}]")
    del q, k, v, got, want

    replay_row = replay_paged(paged_args["replay"], "B=1 prompt replay",
                              label)
    row = replay_paged(paged_args["batched"], "B=4 batched decode", label)
    row.update(b1_ms=replay_row["ms"], b1_graph_ms=replay_row["graph_ms"],
               b1_splits=replay_row["splits"],
               max_abs_err=max(row["max_abs_err"],
                               replay_row["max_abs_err"]))
    rows["paged_attention"] = row
    return rows


# ------------------------------------------------------- training slice


def grad_close(got, want, tol, what):
    """Max |got - want| of each (dq, dk, dv) pair after checking it
    against ``tol`` x the largest |want| of the same gradient."""
    worst = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        if not torch.isfinite(g).all() or err > tol * max(scale, 1e-30):
            raise AssertionError(f"{what} {name}: max abs err {err} beyond "
                                 f"{tol} x {scale}")
        worst = max(worst, err)
    return worst


# The backward kernels' edge cases (B, Sq, Sk, H, Hk, causal, q_offset),
# at every head dim and (q/k, value) pair.
BWD_EDGES = (
    (2, 256, 256, 4, 4, True, 0),      # rep 1
    (1, 320, 320, 6, 2, True, 0),      # rep 3
    (1, 200, 136, 3, 1, False, 0),     # ragged, non-causal
    (1, 64, 256, 2, 2, True, 192),     # q_offset
    # Partial key and query tiles on the diagonal.
    (1, 200, 200, 2, 2, True, 0),
    # Several query stages and head switches in one ring.
    (1, 384, 384, 6, 2, True, 0),
    # A key tile that straddles the offset.
    (1, 64, 320, 2, 1, True, 192))


def bwd_case(rng, dev, b, sq, sk, h, hk, d, dtype, causal, q_offset=0,
             dv=None):
    """One ``flash_attention_bwd`` call against ``attention_bwd_ref`` on
    the same forward (out, lse), heads-first, at q/k head dim ``d`` and
    value head dim ``dv`` (``d`` by default); checks the forward's lse
    against the plain one and the backward's bits against a second
    launch. Returns the max abs error and the inputs (q, k, v, out, lse,
    dout)."""
    dv = d if dv is None else dv
    q = randn(rng, (b, h, sq, d), dtype, dev)
    k = randn(rng, (b, hk, sk, d), dtype, dev)
    v = randn(rng, (b, hk, sk, dv), dtype, dev)
    dout = randn(rng, (b, h, sq, dv), dtype, dev)
    what = (f"flash bwd B{b} Sq{sq} Sk{sk} H{h}/{hk} D{d} DV{dv} {dtype} "
            f"causal={causal} q_offset={q_offset}")
    out, lse = flash.flash_attention_fwd(q, k, v, causal=causal, bq=1, bk=1,
                                         q_offset=q_offset, return_lse=True)
    _, lse_plain = attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                 return_lse=True)
    close(lse, lse_plain, 1e-3, 1e-4, f"{what}: lse")
    got = flash.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                    q_offset=q_offset)
    again = flash.flash_attention_bwd(q, k, v, out, lse, dout,
                                      causal=causal, q_offset=q_offset)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{what}: two launches differ")
    want = attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                             q_offset=q_offset)
    err = grad_close(got, want, BWD_TOL[dtype], what)
    return err, (q, k, v, out, lse, dout)


def phase_train_kernels(dev):
    """The backward kernels against their plain version at the training
    shape and on an edge sweep; returns the largest error."""
    rng = np.random.default_rng(15)
    cfg = get_config(ARCH)
    hd = cfg.resolved_head_dim
    err, _ = bwd_case(rng, dev, TRAIN_B, TRAIN_S, TRAIN_S, cfg.n_heads,
                      cfg.n_kv_heads, hd, torch.bfloat16, True)
    log(f"train-kernels: flash_attention_bwd at the training shape (B "
        f"{TRAIN_B}, S {TRAIN_S}, H {cfg.n_heads}/{cfg.n_kv_heads}, D {hd}, "
        f"causal, bf16) == attention_bwd_ref within {BWD_TOL[torch.bfloat16]}"
        f" x max |g|, two launches equal bit for bit, max_abs_err {err}")
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in flash.HEAD_DIMS:
            for b, sq, sk, h, hk, causal, off in BWD_EDGES:
                e, _ = bwd_case(rng, dev, b, sq, sk, h, hk, d, dtype, causal,
                                off)
                err = max(err, e)
                cases += 1
    # Padded S through the model's entry point: autograd of the blockwise
    # path (the wrapper pads S = 130 to 256) against the plain one.
    for dtype in (torch.float32, torch.bfloat16):
        for causal, s in ((True, 130), (False, 256)):
            t = [randn(rng, (1, s, hh, 64), dtype, dev).requires_grad_(True)
                 for hh in (6, 2, 2)]
            dout = randn(rng, (1, s, 6, 64), dtype, dev)
            got = torch.autograd.grad(model_attention._blockwise_attention(
                *t, causal, "kernel"), t, dout)
            want = torch.autograd.grad(model_attention._blockwise_attention(
                *t, causal, "plain"), t, dout)
            err = max(err, grad_close(got, want, AUTOGRAD_TOL[dtype],
                                      f"blockwise autograd S{s} {dtype} "
                                      f"causal={causal}"))
            cases += 1
    log(f"train-kernels: {cases} edge cases (fp32 and bf16, D {flash.HEAD_DIMS}"
        f", GQA rep 1 and 3, ragged non-causal Sk, q_offset 192, causal "
        f"S 200 and 384, padded S through autograd of the blockwise path): "
        f"kernel == plain within "
        f"{BWD_TOL[torch.float32]} (fp32) / {BWD_TOL[torch.bfloat16]} (bf16) "
        f"x max |g| ({AUTOGRAD_TOL[torch.bfloat16]} through autograd, where "
        f"the forwards differ too), forward lse == plain, bits equal run to "
        f"run, max_abs_err {err}")
    return err


def train_pipeline(root, vocab, seed, batch=TRAIN_B, seq=TRAIN_S):
    """The raw-array token pipeline of the train phase: a corpus of
    documents up to S + 1 tokens from ``seed`` in HDF5 files over 4
    hosts, batches of B x S under the cost policy."""
    files, _ = make_token_corpus(TRAIN_SAMPLES, seq + 1, vocab,
                                 TRAIN_FILES, seed)
    catalog, data = build_catalog(files, str(root), "hdf5", TRAIN_HOSTS)
    return RawArrayTokenPipeline(catalog, FileReader(catalog, data),
                                 n_hosts=TRAIN_HOSTS,
                                 host_budget_bytes=TRAIN_HOST_BUDGET,
                                 batch=batch, seq=seq, policy="cost")


def on_card(batch, dev):
    """A batch (numpy arrays or CPU tensors) as card tensors."""
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def rel_l2(got, want):
    """||got - want||_2 / ||want||_2 in fp32."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp(min=1e-30))


def compare_grads(names, got, want):
    """(largest relative L2 error over the leaves, its leaf, the global
    norms of got and want) of two gradient lists."""
    errs = [(rel_l2(g, w), n) for n, g, w in zip(names, got, want)]
    worst = max(errs)
    norm = lambda gs: float(torch.sqrt(sum(  # noqa: E731
        torch.sum(torch.square(g.float())) for g in gs)))
    return worst[0], worst[1], norm(got), norm(want)


def autograd_attention_ref(q, k, v, *, causal=True, bq=128, bk=128,
                           impl="plain"):
    """The floor's attention: ``attention_ref`` differentiated by
    autograd, in the model's (B, S, H, D) layout (S needs no padding at
    the train phase's shape)."""
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)


def phase_train(dev, root, seed):
    """llama3.2-3b trained at full width and depth from the raw-array
    pipeline: the first step's gradients against the plain versions' (and
    the floor), then TRAIN_STEPS steps of ``make_train_step(remat=True)``
    timed, one more profiled. Returns the launches of the timed steps."""
    cfg = get_config(ARCH)
    label = card_label()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    pipeline = train_pipeline(root, cfg.vocab_size, seed)
    log(f"train: pipeline over {TRAIN_SAMPLES} documents of up to "
        f"{TRAIN_S + 1} tokens in {TRAIN_FILES} hdf5 files on {TRAIN_HOSTS} "
        f"hosts, built in {time.perf_counter() - t0:.3f} s")
    params = init_params(cfg, seed=seed, device=dev)
    names = [n for n, _ in named_leaves(params)]
    n_params = sum(t.numel() for t in leaves(params))
    batch = on_card(pipeline.next_batch(), dev)

    # The first step's gradients: kernels, plain versions, and the floor
    # (two plain formulations of the backward).
    def grads(impl, attention=None):
        lfn = functools.partial(loss_fn, cfg=cfg, remat=True, impl=impl)
        saved = model_attention.flash_attention
        if attention is not None:
            model_attention.flash_attention = attention
        try:
            t = time.perf_counter()
            metrics, g = value_and_grad(params, lfn, batch)
            torch.cuda.synchronize()
            return float(metrics["loss"]), g, time.perf_counter() - t
        finally:
            model_attention.flash_attention = saved

    loss_k, g_k, wall_k = grads("kernel")
    loss_p, g_p, wall_p = grads("plain")
    err, leaf, norm_k, norm_p = compare_grads(names, g_k, g_p)
    del g_k
    loss_f, g_f, wall_f = grads("plain", autograd_attention_ref)
    floor_err, floor_leaf, norm_f, _ = compare_grads(names, g_f, g_p)
    del g_f, g_p
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    norm_rel = abs(norm_k - norm_p) / norm_p
    if not (np.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_REL and
            norm_rel <= TRAIN_GNORM_REL and err <= TRAIN_LEAF_REL_L2):
        raise AssertionError(
            f"train: kernel step vs plain step: loss {loss_k} vs {loss_p} "
            f"(relative {loss_rel}, bound {TRAIN_LOSS_REL}), grad norm "
            f"{norm_k} vs {norm_p} (relative {norm_rel}, bound "
            f"{TRAIN_GNORM_REL}), worst leaf {leaf} relative L2 {err} "
            f"(bound {TRAIN_LEAF_REL_L2})")
    log(f"train[plain]: first step's gradients of all {len(names)} leaves "
        f"({n_params} parameters) from one batch: kernel vs plain loss "
        f"{loss_k} vs {loss_p} (relative {loss_rel}, bound "
        f"{TRAIN_LOSS_REL}), grad norm {norm_k} vs {norm_p} (relative "
        f"{norm_rel}, bound {TRAIN_GNORM_REL}), worst leaf {leaf} relative "
        f"L2 {err} (bound {TRAIN_LEAF_REL_L2}); floor (attention_bwd_ref vs "
        f"autograd through attention_ref): loss {loss_f}, grad norm {norm_f},"
        f" worst leaf {floor_leaf} relative L2 {floor_err}; walls kernel "
        f"{wall_k:.3f} s, plain {wall_p:.3f} s, floor {wall_f:.3f} s")

    # The timed steps: the main path of the training slice.
    opt_cfg = OptimizerConfig(peak_lr=3e-4, warmup_steps=2,
                              total_steps=TRAIN_STEPS + 1)
    opt_state = adamw_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, walls, data_s = [], [], [], 0.0
    zero_launches()
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        batch = on_card(pipeline.next_batch(), dev)
        data_s += time.perf_counter() - t
        t = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))   # synchronizes
        walls.append(time.perf_counter() - t)
        gnorms.append(float(metrics["grad_norm"]))
    launches = step_launches()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention_fwd": 2 * cfg.n_layers * TRAIN_STEPS,
            "flash_attention_bwd": cfg.n_layers * TRAIN_STEPS,
            "adamw": TRAIN_STEPS * adamw_step_launches(params)}
    if launches != want or paged.LAUNCHES["paged_attention"] or \
            not all(np.isfinite(losses)):
        raise AssertionError(f"train: launches {launches} (want {want}, "
                             f"forward twice a layer under remat, the "
                             f"AdamW kernels every step), paged "
                             f"{paged.LAUNCHES['paged_attention']}, losses "
                             f"{losses}")
    med = float(np.median(walls[1:]))
    TRAIN_RUN.update(losses=losses, grad_norms=gnorms, median_s=med)
    tokens = TRAIN_B * TRAIN_S
    live = TRAIN_B * cfg.n_heads * TRAIN_S * (TRAIN_S + 1) // 2
    model_flops = 6 * n_params * tokens
    attn_flops = 12 * cfg.resolved_head_dim * live * cfg.n_layers
    mfu = (model_flops + attn_flops) / med / BF16_FLOPS_PER_S
    log(f"train: {ARCH} B={TRAIN_B} S={TRAIN_S}, bf16 params, fp32 AdamW "
        f"moments, remat per layer, {TRAIN_STEPS} steps: losses {losses}; "
        f"step walls {[round(w, 6) for w in walls]} s, median after the "
        f"first {med:.6f} s = {tokens / med:.1f} tokens/s; MFU {mfu:.6f} "
        f"({model_flops:.4e} model flops 6 N T + {attn_flops:.4e} attention "
        f"flops 12 D per live pair, no remat, against {BF16_FLOPS_PER_S:.3e}"
        f" flop/s); pipeline {data_s:.3f} s in all; launches {launches}; "
        f"max_memory_allocated {peak} bytes (params, moments and steps; "
        f"{base} bytes were allocated before the phase began) [{label}]")

    # One step in its two halves, each timed alone.
    batch = on_card(pipeline.next_batch(), dev)
    t = time.perf_counter()
    _, g = value_and_grad(params, functools.partial(
        loss_fn, cfg=cfg, remat=True), batch)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t
    t = time.perf_counter()
    it = iter(g)
    adamw_update(params, tree_map(lambda _: next(it), params), opt_state,
                 opt_cfg, reference_decay_mask(params))
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t
    del g
    log(f"train: one step in halves: loss and gradients (forward, "
        f"recompute, backward) {grad_s:.6f} s, AdamW update {opt_s:.6f} s "
        f"[{label}]")

    def one_step():
        batch = on_card(pipeline.next_batch(), dev)
        out = step(params, opt_state, batch)
        return float(out[2]["loss"])

    t = time.perf_counter()
    one_step()
    wall = time.perf_counter() - t
    _, pwall, activity = profiled(one_step)
    log(f"train: one more whole step {wall:.6f} s, then one under "
        f"torch.profiler: "
        f"{share(activity, wall, pwall)}; "
        f"{kernel_time(activity, 'flash_fwd_bf16_kernel')}; "
        f"{kernel_time(activity, 'flash_bwd_')} [{label}]")
    busy, _, by_name = activity
    if busy is not None:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log("train: device time of the profiled step by kernel (top 8): " +
            "; ".join(f"{name[:70]} {sec:.6f} s ({sec / busy:.4f})"
                      for name, sec in top))
    log(f"train: PipelineStats {dataclasses.asdict(pipeline.stats)} "
        f"(epoch {pipeline.epoch}, {pipeline.steps_per_epoch} steps an "
        f"epoch)")
    del params, opt_state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_replay(dev):
    """``flash_attention_bwd`` at the training shape: kernel, plain and
    SDPA-backward times and the bound."""
    cfg = get_config(ARCH)
    hd, h, hk = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    rng = np.random.default_rng(16)
    err, (q, k, v, out, lse, dout) = bwd_case(
        rng, dev, TRAIN_B, TRAIN_S, TRAIN_S, h, hk, hd, torch.bfloat16, True)

    def kernel():
        return flash.flash_attention_bwd(q, k, v, out, lse, dout)
    ms = cuda_ms(kernel)
    reps = 10
    in_graph_ms = graph_ms(kernel, n=reps)
    by_kernel = graph_kernel_ms(kernel, n=reps)
    if by_kernel is None:
        parts = "per kernel: not measured (the profiler saw no device time)"
    else:
        parts = "per kernel in a profiled graph replay: " + ", ".join(
            f"{re.search(r'flash_bwd_[^(]*', name).group(0)} {ms_k:.4f} ms "
            f"({seen} of {reps} launches recorded)"
            for name, (ms_k, seen) in sorted(by_kernel.items(),
                                             key=lambda kv: -kv[1][0])
            if "flash_bwd_" in name)
    plain_ms = cuda_ms(lambda: attention_bwd_ref(q, k, v, out, lse, dout),
                       reps=3)
    qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa, (qs, ks, vs), dout, retain_graph=True))
    live = TRAIN_B * h * TRAIN_S * (TRAIN_S + 1) // 2
    flops = 8 * hd * live
    nbytes = sum(x.nbytes for x in (q, k, v, out, lse, dout)) + \
        q.nbytes + k.nbytes + v.nbytes
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"replay[flash_attention_bwd]: q {tuple(q.shape)} k/v "
        f"{tuple(k.shape)} bf16 causal: kernel {ms:.4f} ms back to back, "
        f"{in_graph_ms:.4f} ms in a CUDA graph = "
        f"{flops / in_graph_ms / 1e9:.1f} TFLOP/s, {in_graph_ms / lib_ms:.3f}"
        f" x sdpa backward; plain {plain_ms:.4f} ms, sdpa backward "
        f"{lib_ms:.4f} ms = {flops / lib_ms / 1e9:.1f} TFLOP/s, bound "
        f"{max(ops_ms, bytes_ms):.6f} ms ({flops} flops, {nbytes} bytes); "
        f"{parts}; earlier {EARLIER['flash_attention_bwd']} "
        f"[{card_label()}]")
    return dict(ms=ms, graph_ms=in_graph_ms, plain_ms=plain_ms,
                library_ms=lib_ms, max_abs_err=err,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def phase_resume(dev, root, seed):
    """Bit-exact resume at reduced size (S = TRAIN_S, so the kernels run):
    train TRAIN_STEPS steps with a checkpoint of the params, the moments
    and the pipeline's state after step 2; restore it into fresh tensors
    and a fresh pipeline and train steps 3 and on again: the losses and
    the final parameters must be equal bit for bit."""
    cfg = get_config(ARCH)
    small = reduced(cfg, **RESUME)
    opt_cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                              total_steps=TRAIN_STEPS)
    step = make_train_step(small, opt_cfg, remat=True)
    pipeline = train_pipeline(root / "data", small.vocab_size, seed)
    params = init_params(small, seed=seed, device=dev)
    opt_state = adamw_init(params, opt_cfg)
    ckpt = AsyncCheckpointer(str(root / "ckpt"), keep=2)
    zero_launches()
    losses = []
    for i in range(TRAIN_STEPS):
        params, opt_state, m = step(params, opt_state,
                                    on_card(pipeline.next_batch(), dev))
        losses.append(float(m["loss"]))
        if i + 1 == 2:
            ckpt.save(2, {"params": params, "opt": opt_state},
                      extra={"pipeline": pipeline.state()})
    ckpt.wait()
    fwd = flash.LAUNCHES["flash_attention_fwd"]
    bwd = flash.LAUNCHES["flash_attention_bwd"]
    like = {"params": init_params(small, seed=seed + 1, device=dev),
            "opt": adamw_init(params, opt_cfg)}
    tree, start, extra = restore_checkpoint(
        latest_checkpoint(str(root / "ckpt")), like)
    p2, o2 = tree["params"], tree["opt"]
    again = RawArrayTokenPipeline(pipeline.cluster.catalog,
                                  pipeline.reader, n_hosts=TRAIN_HOSTS,
                                  host_budget_bytes=TRAIN_HOST_BUDGET,
                                  batch=TRAIN_B, seq=TRAIN_S, policy="cost")
    again.set_state(extra["pipeline"])
    resumed = []
    for _ in range(start, TRAIN_STEPS):
        p2, o2, m = step(p2, o2, on_card(again.next_batch(), dev))
        resumed.append(float(m["loss"]))
    same = all(torch.equal(a, b) for a, b in zip(leaves(params),
                                                  leaves(p2)))
    if resumed != losses[start:] or not same or not bwd:
        raise AssertionError(f"resume: losses {losses}, resumed from step "
                             f"{start}: {resumed}; final params equal: "
                             f"{same}; bwd launches {bwd}")
    log(f"resume: {small.name} (d_model {small.d_model}, {small.n_layers} "
        f"layers, {small.n_heads}/{small.n_kv_heads} heads of "
        f"{small.resolved_head_dim}, vocab {small.vocab_size}), B={TRAIN_B} "
        f"S={TRAIN_S}: {TRAIN_STEPS} steps, losses {losses} (flash launches "
        f"fwd {fwd}, bwd {bwd}); restored step {start} (params, moments, "
        f"pipeline state {extra['pipeline']}) and re-ran steps "
        f"{start + 1}-{TRAIN_STEPS}: losses {resumed}, equal bit for bit, "
        f"final parameters equal bit for bit")


# -------------------------------------------------- MoE and SSM slice

# deepseek-moe-16b as the repo configures it (28 layers, d_model 2048, 16
# / 16 heads of 128, 64 routed experts of 1408 top-6 plus 2 shared,
# capacity_factor 1.25, vocab 102400): prefill and serving at full width
# and depth, training at full width and MOE_TRAIN_LAYERS layers (the 28
# do not fit one card with their gradients and fp32 moments).
MOE_ARCH = "deepseek-moe-16b"
MOE_SERVE = dict(slots=4, max_len=256, page_size=16, policy="cost")
MOE_REQUESTS, MOE_SYS_LEN, MOE_USER_LEN, MOE_NEW_TOKENS = 6, 64, 32, 8
MOE_TRAIN_LAYERS, MOE_TRAIN_B, MOE_TRAIN_STEPS = 4, 1, 3
# xlstm-125m at full size: training at B x S (mLSTM goes chunkwise), then
# the engine.
SSM_ARCH = "xlstm-125m"
SSM_TRAIN_B, SSM_TRAIN_S, SSM_TRAIN_STEPS = 2, 2048, 2
# The profiled step's length: reading a trace of the S 2048 step (about
# 1.4 M events, most of them the sLSTM time loop's) would take minutes;
# every part of the step is linear in S, so the loop's share is not.
# The mLSTM forms are compared at the shortest S that "auto" runs
# chunkwise: the sequential form's gradient at S 2048 takes 96 s
# (measured on one H100).
SSM_PROFILE_S = SSM_CHECK_S = 128
# Decode against the forward on fp32 weights (the step's bf16 GEMMs
# differ in shape between the two, and a bf16 logit moves by up to 0.26
# of its 1.5e1 range over 14.5 M logits, measured on one H100): max abs and
# relative L2 bounds.
SSM_FP32_BOUNDS = (1e-2, 1e-3)
SSM_SERVE = dict(slots=4, max_len=128, page_size=16, policy="cost")
SSM_REQUESTS, SSM_PROMPT, SSM_NEW_TOKENS = 4, 64, 8
# Jamba reduced (8 layers: 7 Mamba + 1 attention, MoE every other layer,
# d_model 512, 4 / 1 heads of 128, vocab 512) with its published
# capacity_factor 1.25 put back.
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA = dict(d_model=512, n_periods=1, vocab=512)
JAMBA_SERVE = dict(slots=4, max_len=128, page_size=16, policy="cost")
JAMBA_REQUESTS, JAMBA_SYS_LEN, JAMBA_USER_LEN, JAMBA_NEW_TOKENS = \
    4, 48, 16, 8
# The routing rule of the MoE phases. A last-bit difference in attention
# can flip a top-k choice or move a token across the capacity cut, and
# every later token of that expert's queue shifts with it. Each phase
# prints the share of (position, layer) routings equal between the kernel
# run and the plain run, and beside it the share between two plain
# formulations (the floor); the kernel run's share may trail the floor's
# by at most ROUTING_MARGIN. The logits are held to the model bounds at
# the positions whose routing agreed in every layer, and, everywhere, in
# a plain run forced onto the kernel run's expert choices (its gates,
# aux loss and gradients its own).
ROUTING_MARGIN = 0.01
# The serving floor's engine replays the first FLOOR_CALLS decode_step
# calls of the kernel run (the whole run is replayed by the plain one).
FLOOR_CALLS = 200
# The routed models' logits and gradients against a floor: deepseek's
# 28 bf16 layers carry more rounding than llama's, so two plain
# formulations of the same step, on the same routing, are themselves
# farther apart than llama's bounds allow (relative L2 0.0404 against
# 0.03 in a prefill, measured on one H100). Each routed phase computes that
# floor and holds the kernel run to the larger of llama's bound and
# FLOOR_FACTOR x the floor (llama's bounds sit about 1.5 x above its own
# floor: 0.03 against 0.0195).
FLOOR_FACTOR = 1.5


def floor_bounds(floor):
    """(max abs, relative L2) bounds of a routed phase's logits given the
    floor's (max abs, relative L2)."""
    return (max(MODEL_MAX_ABS, FLOOR_FACTOR * floor[0]),
            max(MODEL_REL_L2, FLOOR_FACTOR * floor[1]))


def hold(errors, bounds, what):
    """Raise unless both (max abs, relative L2) errors are within
    ``bounds``."""
    if not (errors[0] <= bounds[0] and errors[1] <= bounds[1]):
        raise AssertionError(f"{what}: errors {errors} beyond {bounds}")


def timed(name, fn, *args):
    """``fn(*args)``, logging its seconds under ``name``."""
    t = time.perf_counter()
    out = fn(*args)
    log(f"{name}: {time.perf_counter() - t:.2f} s")
    return out


def routing_signature(r):
    """(T, K) kept expert ids sorted, -1 for a dropped pair: two runs
    dispatch a token alike when these rows are equal."""
    return torch.where(r.keep, r.experts, -1).sort(-1).values


class RoutingRecorder:
    """Stands in for ``repro_torch.models.moe.route`` over one run:
    records each MoE layer's routing under (``call``, the router's
    address), and, given a ``forced`` recorder of another run, routes to
    that run's experts instead (``moe.assign`` on this run's own router
    probabilities, so gates, aux loss and gradients are its own). A
    layer recomputed under remat routes again; ``recomputed`` keeps
    those signatures to be checked against the first."""

    def __init__(self, forced=None):
        self.forced = forced
        self.call = 0
        self.sig, self.experts, self.aux, self.drops = {}, {}, {}, {}
        self.recomputed = []

    def __enter__(self):
        self._route = model_moe.route
        model_moe.route = self
        return self

    def __exit__(self, *exc):
        model_moe.route = self._route

    def __call__(self, router, xt, cfg):
        r = self._route(router, xt, cfg)
        key = (self.call, router.data_ptr())
        sig = routing_signature(r)
        if key in self.sig:
            self.recomputed.append((key, sig))
        else:
            self.sig[key], self.experts[key] = sig, r.experts
            self.aux[key] = r.aux.detach()
            self.drops[key] = (~r.keep).sum()
        if self.forced is None:
            return r
        probs = torch.softmax(xt.float() @ router.float(), dim=-1)
        return model_moe.assign(probs, self.forced.experts[key], cfg)

    def recompute_equal(self) -> bool:
        """Every remat recompute routed as the first pass did."""
        return all(torch.equal(self.sig[k], s) for k, s in self.recomputed)

    def layer_values(self, table):
        """A recorded per-layer table (aux, drops) of call 0, in layer
        order, as floats."""
        return [float(v) for (c, _), v in table.items() if c == 0]


def agreement(a, b):
    """(share of (token, layer) routings equal in the runs ``a`` and
    ``b``, {key: (T,) bool equal}) over the keys both recorded; (1.0,
    {}) for a model without routed layers."""
    keys = [k for k in a.sig if k in b.sig]
    if not keys:
        return 1.0, {}
    same = {k: (a.sig[k] == b.sig[k]).all(-1) for k in keys}
    flat = torch.cat([same[k] for k in keys])
    return float(flat.float().mean()), same


def routing_check(tag, share, floor_share):
    """The routing rule's share check: the kernel run's share may trail
    the floor's by at most ROUTING_MARGIN."""
    if share < floor_share - ROUTING_MARGIN:
        raise AssertionError(
            f"{tag}: kernel run routes {share:.6f} of (position, layer) "
            f"pairs as the plain run, below the floor {floor_share:.6f} "
            f"less {ROUTING_MARGIN}")


def seeded_fields(cfg, kind, rows, seq, rng):
    """Seeded CPU tensors of one step's fields at rows x seq, laid out and
    typed as ``input_specs.batch_shape`` gives them for ``kind`` (train or
    prefill): ids below the vocabulary in the integer fields, standard
    normal draws in the others."""
    fields = batch_shape(cfg, ShapeConfig(kind, kind, seq, rows))
    return {name: torch.from_numpy(
                rng.standard_normal(shape, np.float32)
                if dtype.is_floating_point else
                rng.integers(0, cfg.vocab_size, shape)).to(dtype)
            for name, (shape, dtype) in fields.items()}


def prefill_check(params, cfg, dev, tag, seed, rows=PREFILL_B):
    """``make_prefill_step`` at rows x S 4096 through the flash kernel,
    held against the same step on the plain versions beside the floor
    (naive against blockwise plain attention). A dense model's logits are
    held to the model bounds. A routed model goes under the routing rule:
    the plain step's own routing and, at the rows whose last position
    routed alike in every layer, its logits; the plain step forced onto
    the kernel run's experts, all rows, beside the floor forced alike.
    Returns the flash launches."""
    inputs = {k: v.to(dev) for k, v in seeded_fields(
        cfg, "prefill", rows, PREFILL_S, np.random.default_rng(seed)).items()}
    step = make_prefill_step(cfg)
    step(params, **{k: v[:, :256] for k, v in inputs.items()})  # warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_attn = sum(1 for m, _ in cfg.layer_pattern if m == "attn") * \
        cfg.n_periods
    routed = cfg.moe is not None
    zero_launches()
    with RoutingRecorder() as rk:
        t0 = time.perf_counter()
        got = step(params, **inputs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = flash.LAUNCHES["flash_attention_fwd"]
    peak = torch.cuda.max_memory_allocated()
    if launches != n_attn or paged.LAUNCHES["paged_attention"]:
        raise AssertionError(f"{tag}: flash launched {launches} times (want "
                             f"{n_attn}), paged "
                             f"{paged.LAUNCHES['paged_attention']}")
    _, pwall, activity = profiled(lambda: step(params, **inputs))
    label = card_label()
    shapes = ", ".join(f"{k} {tuple(v.shape)}" for k, v in inputs.items())
    log(f"{tag}: {cfg.name} B={rows} S={PREFILL_S} ({shapes}): wall "
        f"{wall:.6f} s, flash launches {launches}, max_memory_allocated "
        f"{peak} bytes [{label}]")
    log(f"{tag}: {share(activity, wall, pwall)}; "
        f"{kernel_time(activity, 'flash_fwd_bf16_kernel')} [{label}]")
    if routed:
        drops = rk.layer_values(rk.drops)
        aux = rk.layer_values(rk.aux)
        T = rows * PREFILL_S
        mc = cfg.moe
        cap = max(1, int(mc.capacity_factor * mc.top_k * T / mc.n_experts))
        log(f"{tag}: dropped (token, k) pairs per MoE layer (of "
            f"{T * mc.top_k}, capacity {cap} a expert): "
            f"{[int(d) for d in drops]}; aux loss "
            f"{sum(aux):.6f} (per layer {[round(a, 4) for a in aux]})")

    plain = make_prefill_step(cfg, impl="plain")
    naive = make_prefill_step(cfg, attention_impl="naive", impl="plain")
    t0 = time.perf_counter()
    with RoutingRecorder() as rp:
        want = plain(params, **inputs)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with RoutingRecorder() as rn:
        naive_own = naive(params, **inputs)
    torch.cuda.synchronize()
    own_floor = logit_errors(naive_own, want)
    del naive_own
    if not routed:
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        log(f"{tag}[plain]: wall {plain_wall:.6f} s; logits "
            f"{tuple(got.shape)}: kernel vs plain (max_abs_err, relative L2 "
            f"err) {logit_errors(got, want)} (bounds {MODEL_MAX_ABS}, "
            f"{MODEL_REL_L2}), argmax agrees at {agree:.6f} of positions; "
            f"floor (plain naive vs plain blockwise attention) {own_floor}")
        close_logits(got, want, f"{tag} logits")
        return launches
    with RoutingRecorder(forced=rk):
        forced = plain(params, **inputs)
    with RoutingRecorder(forced=rk):
        naive_forced = naive(params, **inputs)
    torch.cuda.synchronize()
    share_k, same_k = agreement(rk, rp)
    share_f, _ = agreement(rn, rp)
    # The last position of each row, held where it routed alike in every
    # layer.
    last = torch.stack([s.view(rows, PREFILL_S)[:, -1]
                        for s in same_k.values()]).all(0)
    held = [int(i) for i in torch.nonzero(last).flatten()]
    own = logit_errors(got[held], want[held]) if held else None
    forced_err = logit_errors(got, forced)
    floor = logit_errors(naive_forced, forced)
    bounds = floor_bounds(floor)
    log(f"{tag}[plain]: routings equal to the plain run's {share_k:.6f} of "
        f"(position, layer) pairs, floor (naive vs blockwise plain) "
        f"{share_f:.6f}, margin {ROUTING_MARGIN}; logits (max_abs_err, "
        f"relative L2 err) at the rows whose last position routed alike in "
        f"every layer {held}: {own} (floor, each on its own routing: "
        f"{own_floor}); on the kernel run's routing, all {rows} rows: "
        f"{forced_err} (floor, both on that routing: {floor}); bounds "
        f"{bounds} (the larger of {MODEL_MAX_ABS}, {MODEL_REL_L2} and "
        f"{FLOOR_FACTOR} x the floor)")
    routing_check(tag, share_k, share_f)
    if held:
        hold(own, floor_bounds(own_floor), f"{tag} logits, rows {held}")
    hold(forced_err, bounds, f"{tag} logits on the kernel run's routing")
    return launches


def reference_rounding_attention(q, kp, vp, table, sl, impl="plain"):
    """The floor's second plain formulation of decode attention: the
    reference's decode arithmetic (scores from the bf16 product, fp32
    softmax, probabilities rounded to bf16 before the value product) on
    the dense view of the pages."""
    b, h, d = q.shape
    _, ps, hk, _ = kp.shape
    n = table.shape[1] * ps
    idx = table.long()
    k = kp[idx].reshape(b, n, hk, d).repeat_interleave(h // hk, dim=2)
    v = vp[idx].reshape(b, n, hk, d).repeat_interleave(h // hk, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q, k).float() / math.sqrt(d)
    live = torch.arange(n, device=q.device)[None, None, :] < sl[:, None, None]
    p = torch.softmax(torch.where(live, s, -1e30), dim=-1).to(q.dtype)
    return torch.einsum("bhs,bshd->bhd", p, v)


class ReplayDone(Exception):
    """A ``ForcedReplay`` has replayed the calls it was asked to."""


class ForcedReplay:
    """Stands in for a plain-version engine's decode step, teacher-forced
    on a kernel run's calls: runs the step, keeps its logits, the largest
    errors against the kernel run's and the calls whose argmax differs
    from the kernel run's token, and hands the engine the kernel run's
    logits, so it follows the recorded tokens. A ``router`` (the forced
    ``RoutingRecorder`` of a routed model) is told each call's number.
    Raises ``ReplayDone`` before call ``stop``."""

    def __init__(self, engine, calls, router=None, stop=None):
        self.calls, self.router = calls, router
        self.stop = len(calls) if stop is None else stop
        self.n, self.max_err, self.max_rel = 0, 0.0, 0.0
        self.logits = []
        self.token_diffs = []
        self.slot = None
        self._decode = engine._decode
        self._prefill = engine._prefill_into_slot
        engine._decode = self
        engine._prefill_into_slot = self.prefill

    def prefill(self, state, slot, tokens, start):
        """Tag the replay steps of one admission with their slot."""
        self.slot = slot
        try:
            return self._prefill(state, slot, tokens, start)
        finally:
            self.slot = None

    def __call__(self, params, tokens, state, pos):
        """One plain step, compared with the recorded kernel step."""
        if self.n == self.stop:
            raise ReplayDone
        slot, rtok, rpos, rlogits = self.calls[self.n]
        if slot != self.slot or not torch.equal(tokens, rtok) or \
                not torch.equal(pos, rpos):
            raise AssertionError(f"plain replay diverged at call {self.n}")
        if self.router is not None:
            self.router.call = self.n
        logits, state = self._decode(params, tokens, state, pos)
        self.logits.append(logits[:, -1])
        err, rel = logit_errors(rlogits, logits[:, -1])
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"serving logits, call {self.n}: not "
                                 f"finite")
        self.max_err, self.max_rel = max(self.max_err, err), \
            max(self.max_rel, rel)
        diff = rlogits.argmax(-1) != logits[:, -1].argmax(-1)
        if bool(diff.any()):
            self.token_diffs.append((self.n, diff.nonzero().flatten()
                                     .tolist()))
        self.n += 1
        return rlogits[:, None, :], state


def serve_check(params, cfg, dev, tag, serve_kw, n_req, sys_len, user_len,
                new_tokens, probe_pos=None):
    """``ServingEngine`` through the paged kernel: a routed model's
    prompt-replay steps must run all lanes, a dense model's its own lane;
    a plain engine replays the run teacher-forced, on the kernel run's
    routing (logits held at every call, EngineStats and tokens equal),
    recording its own routing; a third engine does the same with the
    reference's rounding of decode attention, for the floor. A dense
    model's logits are held to the model bounds, a routed model's under
    the routing rule. Returns the paged launches, the run's decode_step
    calls (``StepRecorder.calls``) and, with ``probe_pos``, the first
    layer's paged inputs of the replay step there ("replay") and of the
    batched step with the most live positions ("batched")."""
    def requests():
        reqs = synth_requests(n_req, cfg.vocab_size, seed=0,
                              sys_len=sys_len, user_len=user_len)
        for r in reqs:
            r.max_new_tokens = new_tokens
        return reqs

    n_attn = sum(1 for m, _ in cfg.layer_pattern if m == "attn") * \
        cfg.n_periods
    routed = cfg.moe is not None
    engine = ServingEngine(cfg, params, device=dev, **serve_kw)
    probes = {}
    inner = model_attention.paged_decode_attention

    def probe(q, kp, vp, table, sl, impl="kernel"):
        # The first layer's paged call of the steps ``capture`` names.
        if recorder.capture:
            probes.setdefault(recorder.capture, []).append(
                [x.clone() for x in (q, kp, vp, table, sl)])
            recorder.capture = None
        return inner(q, kp, vp, table, sl, impl=impl)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    model_attention.paged_decode_attention = probe
    try:
        with RoutingRecorder() as rk:
            recorder = StepRecorder(engine, rk, probe_pos)
            t0 = time.perf_counter()
            done = engine.run(requests())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        model_attention.paged_decode_attention = inner
    launches = paged.LAUNCHES["paged_attention"]
    peak = torch.cuda.max_memory_allocated()
    calls = recorder.calls
    n_calls = len(calls)
    replay = [c for c in calls if c[0] is not None]
    lanes = {c[1].shape[0] for c in replay}
    # A routed model replays a prompt on every lane, a dense one on its
    # own lane alone (ServingEngine).
    want_lanes = serve_kw["slots"] if engine.all_lane_replay else 1
    if launches != n_attn * n_calls or \
            flash.LAUNCHES["flash_attention_fwd"] or \
            lanes != {want_lanes} or \
            len(replay) != n_req * (sys_len + user_len):
        raise AssertionError(
            f"{tag}: paged launched {launches} times for {n_calls} calls "
            f"(want {n_attn} a call), flash "
            f"{flash.LAUNCHES['flash_attention_fwd']}; {len(replay)} "
            f"prompt-replay steps on {lanes} lanes")
    st = engine.stats
    generated = sum(len(r.generated) for r in done)
    if len(done) != n_req or generated != n_req * new_tokens:
        raise AssertionError(f"{tag}: served {len(done)} requests, "
                             f"{generated} tokens")
    label = card_label()
    drops = sum(int(d) for d in rk.drops.values())
    pairs = sum(int(s.numel()) for s in rk.sig.values())
    log(f"{tag}: {cfg.name} {serve_kw}, {n_req} requests of {sys_len} shared"
        f" + {user_len} own prompt tokens, {new_tokens} new each: "
        f"{dataclasses.asdict(st)}")
    log(f"{tag}: engine.run {wall:.6f} s wall, {generated} tokens = "
        f"{generated / wall:.3f} generated tokens/s; {n_calls} decode_step "
        f"calls = {1e3 * wall / n_calls:.4f} ms per call; {len(replay)} "
        f"prompt-replay steps, every one on {want_lanes} lane(s); "
        f"paged launches {launches}; dropped {drops} of {pairs} routed "
        f"(token, k) pairs; max_memory_allocated {peak} bytes [{label}]")

    runs = {}
    for name, attention, stop in (
            ("plain", None, n_calls),
            ("floor", reference_rounding_attention, min(FLOOR_CALLS,
                                                         n_calls))):
        inner = model_attention.paged_decode_attention
        if attention is not None:
            model_attention.paged_decode_attention = attention
        try:
            plain = ServingEngine(cfg, params, device=dev, impl="plain",
                                  **serve_kw)
            with RoutingRecorder(forced=rk) as rr:
                replayer = ForcedReplay(plain, calls, rr, stop)
                try:
                    done2 = plain.run(requests())
                except ReplayDone:
                    done2 = None
                torch.cuda.synchronize()
        finally:
            model_attention.paged_decode_attention = inner
        if replayer.n != stop or (done2 is not None and (
                dataclasses.asdict(plain.stats) != dataclasses.asdict(st)
                or [r.generated for r in done2] !=
                [r.generated for r in done])):
            raise AssertionError(f"{tag}[{name}]: replay made {replayer.n} "
                                 f"of {stop} calls, stats {plain.stats}")
        runs[name] = (rr, replayer)
    rp, plain_replay = runs["plain"]
    floor_replay = runs["floor"][1]
    share_k, same_k = agreement(rk, rp)
    share_f, _ = agreement(runs["floor"][0], rp)
    floor_err = max(logit_errors(a, b)[0] for a, b in
                    zip(floor_replay.logits, plain_replay.logits))
    floor_rel = max(logit_errors(a, b)[1] for a, b in
                    zip(floor_replay.logits, plain_replay.logits))
    # Each argmax difference, with the routing flips of its call.
    layers = {}
    for c, ptr in rk.sig:
        layers.setdefault(ptr, len(layers))
    flips = []
    for n, diff_lanes in plain_replay.token_diffs:
        where = [(layers[ptr], lane) for (c, ptr), s in same_k.items()
                 if c == n for lane in range(s.numel()) if not bool(s[lane])]
        flips.append(f"call {n} lanes {diff_lanes}: routing flips (layer, "
                     f"lane) {where or 'none (a near-tie of the logits)'}")
    if routed:
        bounds = floor_bounds((floor_err, floor_rel))
        rule = (f"the larger of {MODEL_MAX_ABS}, {MODEL_REL_L2} and "
                f"{FLOOR_FACTOR} x the floor")
    else:
        bounds, rule = (MODEL_MAX_ABS, MODEL_REL_L2), "the model bounds"
    log(f"{tag}[plain]: teacher-forced replay of all {n_calls} calls on the "
        f"kernel run's routing: logits max_abs_err {plain_replay.max_err}, "
        f"relative L2 err at most {plain_replay.max_rel} (floor, the "
        f"reference's rounding of decode attention against the plain "
        f"version, both on that routing, first {floor_replay.n} calls: "
        f"{floor_err}, {floor_rel}; bounds {bounds}, {rule}); EngineStats "
        f"equal; routings equal to the plain run's {share_k:.6f} of "
        f"(position, layer) pairs, floor {share_f:.6f}, margin "
        f"{ROUTING_MARGIN}; the plain argmax differs from the served token "
        f"in {len(flips)} calls"
        + ("" if not flips else ": " + "; ".join(flips[:8])))
    routing_check(tag, share_k, share_f)
    hold((plain_replay.max_err, plain_replay.max_rel), bounds,
         f"{tag} serving logits")
    kept = {} if probe_pos is None else {
        "replay": probes["replay"][0],
        "batched": max(probes["batched"],
                       key=lambda args: int(args[4].sum()))}
    return launches, calls, kept


def active_params(params, cfg):
    """Parameters a token uses: all but the routed experts it is not
    sent to ((E - K) / E of every expert stack)."""
    n = sum(t.numel() for t in leaves(params))
    mc = cfg.moe
    for layer in params["layers"]:
        for name in ("w_in", "w_gate", "w_out"):
            if name in layer.get("mlp", {}) and "router" in layer["mlp"]:
                n -= layer["mlp"][name].numel() * (mc.n_experts - mc.top_k) \
                    // mc.n_experts
    return n


def train_grads(params, cfg, batch, router, impl="kernel"):
    """(metrics, gradients, seconds) of one batch under ``router``."""
    lfn = functools.partial(loss_fn, cfg=cfg, remat=True, impl=impl)
    with router:
        t = time.perf_counter()
        metrics, g = value_and_grad(params, lfn, batch)
        torch.cuda.synchronize()
    return metrics, g, time.perf_counter() - t


def grad_errors(names, got, want):
    """(loss relative error, grad-norm relative error, worst leaf's
    relative L2 error, log fragment) of two (metrics, gradients) pairs."""
    (mg, gg), (mw, gw) = got, want
    err, leaf, norm_g, norm_w = compare_grads(names, gg, gw)
    loss_g, loss_w = float(mg["loss"]), float(mw["loss"])
    loss_rel = abs(loss_g - loss_w) / abs(loss_w)
    norm_rel = abs(norm_g - norm_w) / norm_w
    if not np.isfinite(loss_g):
        loss_rel = float("inf")
    return (loss_rel, norm_rel, err,
            f"loss {loss_g} vs {loss_w} (relative {loss_rel}), grad norm "
            f"{norm_g} vs {norm_w} (relative {norm_rel}), worst leaf {leaf} "
            f"relative L2 {err}")


TRAIN_BOUNDS = (TRAIN_LOSS_REL, TRAIN_GNORM_REL, TRAIN_LEAF_REL_L2)


def timed_steps(tag, cfg, params, pipeline, dev, steps, opt_cfg,
                remat=True):
    """One warm-up step and ``steps`` timed steps of ``make_train_step``,
    the launch counts set to 0 before the timed ones: (losses, aux
    losses, step walls, launches, peak memory, opt state, step)."""
    opt_state = adamw_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, remat=remat)
    params, opt_state, _ = step(params, opt_state,
                                on_card(pipeline.next_batch(), dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    losses, auxes, walls = [], [], []
    for _ in range(steps):
        batch = on_card(pipeline.next_batch(), dev)
        t = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))   # synchronizes
        walls.append(time.perf_counter() - t)
        auxes.append(float(metrics["aux_loss"]))
    launches = step_launches()
    if not all(np.isfinite(losses)) or paged.LAUNCHES["paged_attention"]:
        raise AssertionError(f"{tag}: losses {losses}, paged "
                             f"{paged.LAUNCHES['paged_attention']}")
    return (losses, auxes, walls, launches, torch.cuda.max_memory_allocated(),
            opt_state, step)


def phase_moe_train(dev, root, seed):
    """deepseek-moe-16b at full width and MOE_TRAIN_LAYERS layers trained
    from the raw-array pipeline at B 1 x S 4096: the first step's
    gradients against the plain step's on the kernel run's routing, the
    routing rule's shares (floor: naive against blockwise plain
    attention), the kernel step run twice for bit equality, then timed
    steps. Returns the flash launches of the timed steps."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    label = card_label()
    pipeline = train_pipeline(root, cfg.vocab_size, seed, batch=MOE_TRAIN_B)
    params = init_params(cfg, seed=seed, device=dev)
    names = [n for n, _ in named_leaves(params)]
    n_params = sum(t.numel() for t in leaves(params))
    n_active = active_params(params, cfg)
    batch = on_card(pipeline.next_batch(), dev)

    rk = RoutingRecorder()
    mk, g_k, wall_k = train_grads(params, cfg, batch, rk)
    mk2, g_k2, _ = train_grads(params, cfg, batch, RoutingRecorder())
    bit_equal = float(mk["loss"]) == float(mk2["loss"]) and all(
        torch.equal(a, b) for a, b in zip(g_k, g_k2))
    del g_k2
    mf, g_f, wall_f = train_grads(params, cfg, batch,
                                  RoutingRecorder(forced=rk), impl="plain")
    *errs, msg = grad_errors(names, (mk, g_k), (mf, g_f))
    del g_k
    # The floor: the plain step with autograd through attention_ref
    # against the plain step (attention_bwd_ref), both on the kernel
    # run's routing.
    saved = model_attention.flash_attention
    model_attention.flash_attention = autograd_attention_ref
    try:
        ma, g_a, _ = train_grads(params, cfg, batch,
                                 RoutingRecorder(forced=rk), impl="plain")
    finally:
        model_attention.flash_attention = saved
    *floor, floor_msg = grad_errors(names, (ma, g_a), (mf, g_f))
    del g_a, g_f
    bounds = tuple(max(b, FLOOR_FACTOR * f) for b, f in zip(TRAIN_BOUNDS,
                                                            floor))
    with torch.no_grad():
        with RoutingRecorder() as rp:
            forward(params, cfg, tokens=batch["tokens"], impl="plain")
        with RoutingRecorder() as rn:
            forward(params, cfg, tokens=batch["tokens"], impl="plain",
                    attention_impl="naive")
    share_k, _ = agreement(rk, rp)
    share_f, _ = agreement(rn, rp)
    log(f"moe-train[plain]: first step's gradients of all {len(names)} "
        f"leaves ({n_params} parameters, {n_active} active a token) from "
        f"one batch, kernel step vs plain step on its routing: {msg}; floor "
        f"(autograd through attention_ref vs attention_bwd_ref, same "
        f"routing): {floor_msg}; bounds (loss, grad norm, leaf) {bounds}, "
        f"the larger of {TRAIN_BOUNDS} and {FLOOR_FACTOR} x the floor; "
        f"routings equal to "
        f"the plain forward's {share_k:.6f} of (position, layer) pairs, "
        f"floor (naive vs blockwise) {share_f:.6f}, margin "
        f"{ROUTING_MARGIN}; remat recompute routed as the forward: "
        f"{rk.recompute_equal()}; two kernel steps equal bit for bit: "
        f"{bit_equal}; aux loss {float(mk['aux_loss'])}; walls kernel "
        f"{wall_k:.3f} s, plain {wall_f:.3f} s")
    routing_check("moe-train", share_k, share_f)
    if not all(e <= b for e, b in zip(errs, bounds)) or \
            not rk.recompute_equal():
        raise AssertionError(f"moe-train: {msg}")

    opt_cfg = OptimizerConfig(peak_lr=3e-4, warmup_steps=2,
                              total_steps=MOE_TRAIN_STEPS + 2)
    losses, auxes, walls, launches, peak, _, _ = timed_steps(
        "moe-train", cfg, params, pipeline, dev, MOE_TRAIN_STEPS, opt_cfg)
    want = {"flash_attention_fwd": 2 * cfg.n_layers * MOE_TRAIN_STEPS,
            "flash_attention_bwd": cfg.n_layers * MOE_TRAIN_STEPS,
            "adamw": MOE_TRAIN_STEPS * adamw_step_launches(params)}
    if launches != want:
        raise AssertionError(f"moe-train: launches {launches} (want {want})")
    med = float(np.median(walls))
    tokens = MOE_TRAIN_B * TRAIN_S
    live = MOE_TRAIN_B * cfg.n_heads * TRAIN_S * (TRAIN_S + 1) // 2
    model_flops = 6 * n_active * tokens
    attn_flops = 12 * cfg.resolved_head_dim * live * cfg.n_layers
    mfu = (model_flops + attn_flops) / med / BF16_FLOPS_PER_S
    log(f"moe-train: {cfg.name} at {cfg.n_layers} of 28 layers, "
        f"B={MOE_TRAIN_B} S={TRAIN_S}, bf16 params, fp32 AdamW moments, "
        f"remat per layer, 1 warm-up + {MOE_TRAIN_STEPS} timed steps: losses "
        f"{losses}, aux losses {auxes}; step walls "
        f"{[round(w, 6) for w in walls]} s, median {med:.6f} s = "
        f"{tokens / med:.1f} tokens/s; MFU {mfu:.6f} (6 N T over the "
        f"{n_active} active parameters + 12 D per live attention pair, no "
        f"remat, against {BF16_FLOPS_PER_S:.3e} flop/s); launches "
        f"{launches}; max_memory_allocated {peak} bytes [{label}]")
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def slstm_device_time(prof):
    """(forward, backward) device seconds of the sLSTM recurrences in a
    profiled step, and the number of their ranges: the kernels launched
    under the ``slstm_time_loop`` ranges, and those launched by the
    backward of the ops recorded there (events outside the ranges with
    their autograd sequence numbers, outermost only)."""
    def under(e):
        return sum(k.duration for k in e.kernels) + sum(under(c) for c in
                                                        e.cpu_children)

    def inside(e):
        yield e
        for c in e.cpu_children:
            yield from inside(c)

    events = prof.events()
    loops = [e for e in events if e.name == "slstm_time_loop" and
             e.device_type == torch.autograd.DeviceType.CPU]
    in_loops = {id(x) for e in loops for x in inside(e)}
    nrs = {x.sequence_nr for e in loops for x in inside(e)
           if x.sequence_nr >= 0}
    bwd = [e for e in events if e.sequence_nr in nrs and
           id(e) not in in_loops and e.device_type ==
           torch.autograd.DeviceType.CPU]
    ids = {id(e) for e in bwd}

    def outermost(e):
        p = e.cpu_parent
        while p is not None:
            if id(p) in ids:
                return False
            p = p.cpu_parent
        return True

    fwd_us = sum(under(e) for e in loops)
    bwd_us = sum(under(e) for e in bwd if outermost(e))
    return fwd_us / 1e6, bwd_us / 1e6, len(loops)


def phase_ssm(dev, root, seed):
    """xlstm-125m at full size: the first step's gradients with the
    chunkwise mLSTM against the sequential one (fp32 weights), timed bf16
    steps, one profiled (the sLSTM recurrences' share of device time);
    then the engine, and decode against the forward on the card."""
    cfg = get_config(SSM_ARCH)
    label = card_label()
    pipeline = train_pipeline(root, cfg.vocab_size, seed, batch=SSM_TRAIN_B,
                              seq=SSM_TRAIN_S)
    params = init_params(cfg, seed=seed, device=dev)
    names = [n for n, _ in named_leaves(params)]
    n_params = sum(t.numel() for t in leaves(params))
    batch = {k: v[:, :SSM_CHECK_S] for k, v in
             on_card(pipeline.next_batch(), dev).items()}
    # The two mLSTM forms on an fp32 copy of the weights: in bf16 the
    # sequential form rounds each k v^T to bf16 (as the reference's does)
    # where the chunkwise form does not, which the small gate gradients
    # carry at the 1e-1 level; in fp32 the forms must agree.
    wide = tree_map(lambda t: t.float(), params)
    mc, g_c, wall_c = train_grads(wide, cfg, batch, RoutingRecorder())
    seq_cfg = dataclasses.replace(cfg, mlstm_impl="sequential")
    ms_, g_s, wall_s = train_grads(wide, seq_cfg, batch, RoutingRecorder())
    *errs, msg = grad_errors(names, (mc, g_c), (ms_, g_s))
    del g_c, g_s
    log(f"ssm[plain]: {cfg.name} first step's gradients of all {len(names)} "
        f"leaves ({n_params} parameters), B={SSM_TRAIN_B} S={SSM_CHECK_S}, "
        f"fp32 weights, mLSTM chunkwise vs sequential: {msg} (bounds "
        f"{TRAIN_BOUNDS}); walls chunkwise {wall_c:.3f} s, sequential "
        f"{wall_s:.3f} s")
    if not all(e <= b for e, b in zip(errs, TRAIN_BOUNDS)):
        raise AssertionError(f"ssm: {msg}")

    opt_cfg = OptimizerConfig(peak_lr=3e-4, warmup_steps=2,
                              total_steps=SSM_TRAIN_STEPS + 3)
    # No remat: 0.2e9 parameters' activations fit, and remat would run
    # every time loop's forward twice.
    losses, _, walls, launches, peak, opt_state, step = timed_steps(
        "ssm", cfg, params, pipeline, dev, SSM_TRAIN_STEPS, opt_cfg,
        remat=False)
    want = {**{name: 0 for name in flash.LAUNCHES},
            "adamw": SSM_TRAIN_STEPS * adamw_step_launches(params)}
    if launches != want:
        raise AssertionError(f"ssm: launches {launches} (want {want}: no "
                             f"attention kernel)")
    med = float(np.median(walls))
    tokens = SSM_TRAIN_B * SSM_TRAIN_S
    log(f"ssm: {cfg.name} B={SSM_TRAIN_B} S={SSM_TRAIN_S}, bf16 params, "
        f"fp32 AdamW moments, no remat, 1 warm-up + {SSM_TRAIN_STEPS} timed "
        f"steps: losses {losses}; step walls "
        f"{[round(w, 6) for w in walls]} s, median {med:.6f} s = "
        f"{tokens / med:.1f} tokens/s, MFU "
        f"{6 * n_params * tokens / med / BF16_FLOPS_PER_S:.6f} (6 N T); "
        f"launches {launches}; max_memory_allocated {peak} bytes "
        f"[{label}]")

    inner = model_ssm._slstm_recurrence

    def ranged(*args, **kw):
        with torch.profiler.record_function("slstm_time_loop"):
            return inner(*args, **kw)

    model_ssm._slstm_recurrence = ranged
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        batch = {k: v[:, :SSM_PROFILE_S] for k, v in
                 on_card(pipeline.next_batch(), dev).items()}
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            step(params, opt_state, batch)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t
    finally:
        model_ssm._slstm_recurrence = inner
    t = time.perf_counter()
    busy, n_events, by_name = device_activity(prof)
    read = time.perf_counter() - t
    fwd_s, bwd_s, n_loops = slstm_device_time(prof)
    post = time.perf_counter() - t
    busy_msg = "device busy not measured (the profiler saw no device time)"
    if busy:
        busy_msg = (f"device busy {busy:.6f} s of the profiled wall "
                    f"{pwall:.6f} s ({n_events} device events); the sLSTM "
                    f"recurrences ({n_loops} ranges: the input projection "
                    f"and the time loop) {fwd_s:.6f} s forward + {bwd_s:.6f} s "
                    f"backward = {(fwd_s + bwd_s) / busy:.6f} of device "
                    f"busy time; most device time: " + "; ".join(
                        f"{name[:70]} {sec:.6f} s" for name, sec in sorted(
                            by_name.items(), key=lambda kv: -kv[1])[:6]))
    log(f"ssm: one step at B={SSM_TRAIN_B} S={SSM_PROFILE_S} under "
        f"torch.profiler: {busy_msg} (trace read in {read:.1f} s, its "
        f"sLSTM events in {post - read:.1f} s more) [{label}]")
    del opt_state, step

    reqs = [Request(i, np.random.default_rng(20 + i).integers(
        1, cfg.vocab_size, SSM_PROMPT).tolist(), max_new_tokens=SSM_NEW_TOKENS)
        for i in range(SSM_REQUESTS)]
    engine = ServingEngine(cfg, params, device=dev, **SSM_SERVE)
    zero_launches()
    t = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    calls = engine.stats.decode_steps + SSM_REQUESTS * SSM_PROMPT
    if len(done) != SSM_REQUESTS or paged.LAUNCHES["paged_attention"] or \
            any(len(r.generated) != SSM_NEW_TOKENS for r in done):
        raise AssertionError(f"ssm: served {len(done)} requests, paged "
                             f"{paged.LAUNCHES['paged_attention']}")
    # Decode against the forward on the card, fp32 weights: 4 lanes of
    # SSM_PROMPT + SSM_NEW_TOKENS tokens teacher-forced through
    # decode_step, against the forward (S < 128: sequential mLSTM) and
    # the chunkwise forward.
    toks = torch.from_numpy(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (SSM_SERVE["slots"], SSM_PROMPT + SSM_NEW_TOKENS)
    )).to(dev)
    with torch.no_grad():
        state = init_decode_state(cfg, toks.shape[0], toks.shape[1],
                                  device=dev)
        dec = []
        for t in range(toks.shape[1]):
            lg, state = decode_step(wide, cfg, toks[:, t:t + 1], state,
                                    torch.full((toks.shape[0],), t,
                                               dtype=torch.int32,
                                               device=dev))
            dec.append(lg[:, 0])
        dec = torch.stack(dec, 1)
        seq_fwd, _ = forward(wide, cfg, tokens=toks)
        chk_fwd, _ = forward(wide, dataclasses.replace(
            cfg, mlstm_impl="chunkwise"), tokens=toks)
    del wide
    err_s, rel_s = logit_errors(dec, seq_fwd)
    err_c, rel_c = logit_errors(dec, chk_fwd)
    hold((err_s, rel_s), SSM_FP32_BOUNDS, "ssm decode vs forward")
    hold((err_c, rel_c), SSM_FP32_BOUNDS, "ssm decode vs chunkwise forward")
    log(f"ssm: engine {SSM_SERVE}, {SSM_REQUESTS} requests of {SSM_PROMPT} "
        f"+ {SSM_NEW_TOKENS} tokens: {dataclasses.asdict(engine.stats)}; "
        f"engine.run {wall:.6f} s, {calls} decode_step calls = "
        f"{1e3 * wall / calls:.4f} ms per call; decode vs forward over "
        f"{tuple(toks.shape)} tokens on fp32 weights: (max_abs_err, relative "
        f"L2 err) {(err_s, rel_s)} against the forward (sequential mLSTM), "
        f"{(err_c, rel_c)} against the chunkwise forward (bounds "
        f"{SSM_FP32_BOUNDS}) [{label}]")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe(dev, seed):
    """deepseek-moe-16b at full width and depth: prefill and serving under
    the routing rule, then the flash kernels at its MHA shape. Returns
    (launches by phase, [(shape, replay rows)])."""
    cfg = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"model: {MOE_ARCH} at full size, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"{cfg.moe.n_experts} experts of {cfg.d_expert_resolved} top-"
        f"{cfg.moe.top_k} + {cfg.moe.n_shared} shared, capacity_factor "
        f"{cfg.moe.capacity_factor}, {n_params} parameters, random bf16 "
        f"from seed 0 in {time.perf_counter() - t0:.2f} s")
    launches = {"moe-prefill": {"flash_attention_fwd": timed(
        "moe-prefill", prefill_check, params, cfg, dev, "moe-prefill", 19)}}
    launches["moe-serve"] = {"paged_attention": timed(
        "moe-serve", serve_check, params, cfg, dev, "moe-serve", MOE_SERVE,
        MOE_REQUESTS, MOE_SYS_LEN, MOE_USER_LEN, MOE_NEW_TOKENS)[0]}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, [timed("replay[flash MHA]", flash_replay, dev, cfg.name,
                            PREFILL_B, PREFILL_S, cfg.n_heads,
                            cfg.n_kv_heads, cfg.resolved_head_dim, True,
                            True)]


def phase_jamba(dev):
    """Jamba reduced, capacity_factor 1.25: prefill and serving under the
    routing rule. Returns the launches."""
    base = reduced(get_config(JAMBA_ARCH), **JAMBA)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=1.25))
    params = init_params(cfg, seed=0, device=dev)
    log(f"model: {cfg.name} ({cfg.n_layers} layers "
        f"{[m + '+' + p for m, p in cfg.layer_pattern]}, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.top_k}, capacity_factor {cfg.moe.capacity_factor}, "
        f"Mamba d_state {cfg.mamba.d_state}, vocab {cfg.vocab_size}), "
        f"{sum(t.numel() for t in leaves(params))} parameters")
    launches = {"jamba-prefill": {"flash_attention_fwd": timed(
        "jamba-prefill", prefill_check, params, cfg, dev, "jamba-prefill",
        22)}}
    launches["jamba-serve"] = {"paged_attention": timed(
        "jamba-serve", serve_check, params, cfg, dev, "jamba-serve",
        JAMBA_SERVE, JAMBA_REQUESTS, JAMBA_SYS_LEN, JAMBA_USER_LEN,
        JAMBA_NEW_TOKENS)[0]}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------- head dims 80 and 192 --

# hubert-xlarge as the repo configures it (48 layers, d_model 1280, 16
# heads of 80, non-causal, d_ff 5120, vocab 504 masked-unit targets) at
# full size: prefill and training at B 2 x S 4096 frame embeddings.
HUBERT_ARCH = "hubert-xlarge"
HUBERT_STEPS = 2
# HuBERT's masking (arXiv:2106.07447 §4: spans of 10 frames starting at
# 8 % of the frames): a masked frame is labelled with a unit id, the
# others -1 (not counted).
HUBERT_MASK_PROB, HUBERT_SPAN = 0.08, 10
# nemotron-4-340b at full width (d_model 18432, 96 / 8 heads of 192,
# squared-ReLU d_ff 73728, vocab 256000) and 2 of its 96 layers: the 96
# (about 680 GB in bf16) do not fit one card; 2 layers and the two
# embedding tables are about 33 GB.
NEMOTRON_ARCH = "nemotron-4-340b"
NEMOTRON_LAYERS = 2
NEMOTRON_SERVE = dict(slots=4, max_len=512, page_size=16, policy="cost")
NEMOTRON_REQUESTS, NEMOTRON_SYS_LEN, NEMOTRON_USER_LEN, NEMOTRON_NEW = \
    4, 64, 32, 8
# The architectures no earlier phase ran on the card at full width: the
# depth each runs at (None: all of it). phi3.5-moe's 32 layers are about
# 84 GB in bf16; 8 are about 21 GB. One 8-layer period of
# jamba-1.5-large-398b is about 88 GB; its first 4 layers (3 Mamba, 1
# attention, MoE on two) are about 46 GB.
ARCHS = {"qwen1.5-0.5b": None, "olmo-1b": None, "internvl2-2b": None,
         "phi3.5-moe-42b-a6.6b": 8, "jamba-1.5-large-398b": 4}
ARCHS_PREFILL_B = 1
# The kernel of each part of a replay at a model's shape.
REPLAY_KERNEL = {"fwd": "flash_attention_fwd", "bwd": "flash_attention_bwd",
                 "paged": "paged_attention"}
# The engine's run: 4 requests of 8 shared + 8 own prompt tokens, 8 new
# each in 4 slots, so 8 batched decode steps.
ARCHS_SERVE = dict(slots=4, max_len=128, page_size=16, policy="cost")
ARCHS_REQUESTS, ARCHS_SYS_LEN, ARCHS_USER_LEN, ARCHS_NEW = 4, 8, 8, 8


class FrameBatches:
    """Seeded hubert training batches, laid out as ``seeded_fields`` lays
    out a train step's: bf16 frame embeddings, and unit ids kept as
    labels at the masked frames (``HUBERT_MASK_PROB`` span starts of
    ``HUBERT_SPAN`` frames) and -1 elsewhere."""

    def __init__(self, cfg, seed, batch=PREFILL_B, seq=PREFILL_S):
        self.rng = np.random.default_rng(seed)
        self.cfg, self.batch, self.seq = cfg, batch, seq

    def next_batch(self):
        """One batch of ``{"embeds", "labels"}`` CPU tensors."""
        b, s = self.batch, self.seq
        out = seeded_fields(self.cfg, "train", b, s, self.rng)
        starts = self.rng.random((b, s)) < HUBERT_MASK_PROB
        masked = np.zeros((b, s), bool)
        for off in range(HUBERT_SPAN):
            masked[:, off:] |= starts[:, :s - off]
        out["labels"] = torch.where(torch.from_numpy(masked), out["labels"],
                                    -1)
        return out


# The flash forward at a model's shape is also held to a relative L2
# error of its whole output: at S 4096 a non-causal output's values are
# about 0.02 (the sum of 4096 near-even shares of N(0, 1) values), as
# large as the sweep's 2e-2 absolute allowance. Rounding P and the
# output to bf16 alone gives about 2e-3; a scale of 1/sqrt(128) at D 80
# or 192 gives about 0.27 (both on the CPU at S 2048).
FLASH_REPLAY_REL_L2 = 1e-2


def flash_replay(dev, tag, b, s, h, hk, d, causal, backward):
    """The flash forward (and, with ``backward``, the backward) at one
    model's shape, bf16: against the plain version, then kernel back to
    back, in a CUDA graph, plain and SDPA times and the bound. Returns
    (the shape's label, {"fwd": row, "bwd": row})."""
    rng = np.random.default_rng(30 + d)
    label = card_label()
    live = b * h * (s * (s + 1) // 2 if causal else s * s)
    rows = {}
    q = randn(rng, (b, h, s, d), torch.bfloat16, dev)
    k = randn(rng, (b, hk, s, d), torch.bfloat16, dev)
    v = randn(rng, (b, hk, s, d), torch.bfloat16, dev)
    got = flash.flash_attention_fwd(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    err = close(got, want, 2e-2, 2e-2, f"{tag} flash forward")
    rel = rel_l2(got, want)
    if not rel <= FLASH_REPLAY_REL_L2:
        raise AssertionError(f"{tag} flash forward: relative L2 err {rel} "
                             f"beyond {FLASH_REPLAY_REL_L2}")
    del want

    def fwd():
        return flash.flash_attention_fwd(q, k, v, causal=causal)
    ms, in_graph = cuda_ms(fwd), graph_ms(fwd, n=20)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=causal),
                       reps=2)
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True))
    flops = 4 * d * live
    nbytes = q.nbytes + k.nbytes + v.nbytes + got.nbytes
    rows["fwd"] = bound_row(ms, in_graph, plain_ms, lib_ms, err, flops,
                            nbytes)
    rows["fwd"]["rel_l2"] = rel
    log(f"replay[{tag} flash forward]: q {tuple(q.shape)} k/v "
        f"{tuple(k.shape)} bf16 causal={causal}: kernel {ms:.4f} ms back "
        f"to back, {in_graph:.4f} ms in a CUDA graph = "
        f"{flops / in_graph / 1e9:.1f} TFLOP/s, {in_graph / lib_ms:.3f} x "
        f"sdpa; plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{rows['fwd']['bound_ms']:.6f} ms ({flops} flops, {nbytes} "
        f"bytes); max_abs_err {err}, relative L2 err {rel} (bound "
        f"{FLASH_REPLAY_REL_L2}) [{label}]")
    del q, k, v, got
    shape = (f"{tag} B{b} S{s} H{h}/{hk} D{d} "
             f"{'causal' if causal else 'non-causal'}")
    if not backward:
        return shape, rows
    err, (q, k, v, out, lse, dout) = bwd_case(
        rng, dev, b, s, s, h, hk, d, torch.bfloat16, causal)

    def bwd():
        return flash.flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal)
    ms, in_graph = cuda_ms(bwd), graph_ms(bwd, n=10)
    plain_ms = cuda_ms(lambda: attention_bwd_ref(q, k, v, out, lse, dout,
                                                 causal=causal), reps=2)
    qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal, enable_gqa=True)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa, (qs, ks, vs), dout, retain_graph=True))
    flops = 8 * d * live
    nbytes = sum(x.nbytes for x in (q, k, v, out, lse, dout)) + \
        q.nbytes + k.nbytes + v.nbytes
    rows["bwd"] = bound_row(ms, in_graph, plain_ms, lib_ms, err, flops,
                            nbytes)
    log(f"replay[{tag} flash backward]: q {tuple(q.shape)} k/v "
        f"{tuple(k.shape)} bf16 causal={causal}: kernel {ms:.4f} ms back "
        f"to back, {in_graph:.4f} ms in a CUDA graph = "
        f"{flops / in_graph / 1e9:.1f} TFLOP/s, {in_graph / lib_ms:.3f} x "
        f"sdpa backward; plain {plain_ms:.4f} ms, sdpa backward "
        f"{lib_ms:.4f} ms, bound {rows['bwd']['bound_ms']:.6f} ms ({flops} "
        f"flops, {nbytes} bytes); max_abs_err {err} [{label}]")
    return shape, rows


def bound_row(ms, in_graph, plain_ms, lib_ms, err, flops, nbytes):
    """A replay's numbers with its bound: the larger of ``flops`` at the
    bf16 peak and ``nbytes`` at the HBM rate."""
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(ms=ms, graph_ms=in_graph, plain_ms=plain_ms,
                library_ms=lib_ms, max_abs_err=err,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def phase_hubert(dev, seed):
    """hubert-xlarge at full size: the prefill (non-causal flash at D 80)
    held against plain, then training (the first step's gradients
    against the plain step's beside the floor, 1 warm-up and
    HUBERT_STEPS timed steps), then the flash forward and backward at
    its shape. Returns (launches by phase, [(shape, replay rows)])."""
    cfg = get_config(HUBERT_ARCH)
    label = card_label()
    params = init_params(cfg, seed=seed, device=dev)
    names = [n for n, _ in named_leaves(params)]
    n_params = sum(t.numel() for t in leaves(params))
    log(f"model: {cfg.name} at full size, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.resolved_head_dim} "
        f"(non-causal), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{n_params} parameters, random bf16 from seed {seed}")
    launches = {"hubert-prefill": {"flash_attention_fwd": timed(
        "hubert-prefill", prefill_check, params, cfg, dev,
        "hubert-prefill", 23)}}

    batches = FrameBatches(cfg, seed)
    batch = on_card(batches.next_batch(), dev)
    router = RoutingRecorder()
    mk, g_k, wall_k = train_grads(params, cfg, batch, router)
    mp, g_p, wall_p = train_grads(params, cfg, batch, router, impl="plain")
    *errs, msg = grad_errors(names, (mk, g_k), (mp, g_p))
    del g_k
    saved = model_attention.flash_attention
    model_attention.flash_attention = autograd_attention_ref
    try:
        mf, g_f, _ = train_grads(params, cfg, batch, router, impl="plain")
    finally:
        model_attention.flash_attention = saved
    *_, floor_msg = grad_errors(names, (mf, g_f), (mp, g_p))
    del g_f, g_p
    log(f"hubert-train[plain]: first step's gradients of all {len(names)} "
        f"leaves from one batch ({int((batch['labels'] >= 0).sum())} "
        f"masked frames of {batch['labels'].numel()}), kernel step vs "
        f"plain step: {msg}; floor (autograd through attention_ref vs "
        f"attention_bwd_ref): {floor_msg}; bounds (loss, grad norm, leaf) "
        f"{TRAIN_BOUNDS}; walls kernel {wall_k:.3f} s, plain {wall_p:.3f} s")
    if not all(e <= b for e, b in zip(errs, TRAIN_BOUNDS)):
        raise AssertionError(f"hubert-train: {msg}")
    del batch

    opt_cfg = OptimizerConfig(peak_lr=3e-4, warmup_steps=2,
                              total_steps=HUBERT_STEPS + 2)
    losses, _, walls, train_launches, peak, opt_state, step = timed_steps(
        "hubert-train", cfg, params, batches, dev, HUBERT_STEPS, opt_cfg)
    want = {"flash_attention_fwd": 2 * cfg.n_layers * HUBERT_STEPS,
            "flash_attention_bwd": cfg.n_layers * HUBERT_STEPS,
            "adamw": HUBERT_STEPS * adamw_step_launches(params)}
    if train_launches != want:
        raise AssertionError(f"hubert-train: launches {train_launches} "
                             f"(want {want})")
    launches["hubert-train"] = train_launches
    med = float(np.median(walls))
    tokens = PREFILL_B * PREFILL_S
    live = PREFILL_B * cfg.n_heads * PREFILL_S * PREFILL_S
    model_flops = 6 * n_params * tokens
    attn_flops = 12 * cfg.resolved_head_dim * live * cfg.n_layers
    mfu = (model_flops + attn_flops) / med / BF16_FLOPS_PER_S
    log(f"hubert-train: {cfg.name} B={PREFILL_B} S={PREFILL_S}, bf16 "
        f"params, fp32 AdamW moments, remat per layer, 1 warm-up + "
        f"{HUBERT_STEPS} timed steps: losses {losses}; step walls "
        f"{[round(w, 6) for w in walls]} s, median {med:.6f} s = "
        f"{tokens / med:.1f} frames/s; MFU {mfu:.6f} (6 N T + 12 D per "
        f"live attention pair, no remat, against {BF16_FLOPS_PER_S:.3e} "
        f"flop/s); launches {train_launches}; max_memory_allocated {peak} "
        f"bytes [{label}]")

    batch = on_card(batches.next_batch(), dev)

    def one_step():
        out = step(params, opt_state, batch)
        return float(out[2]["loss"])

    t = time.perf_counter()
    one_step()
    wall = time.perf_counter() - t
    _, pwall, activity = profiled(one_step)
    log(f"hubert-train: one more step {wall:.6f} s, then one under "
        f"torch.profiler: {share(activity, wall, pwall)}; "
        f"{kernel_time(activity, 'flash_fwd_bf16_kernel')}; "
        f"{kernel_time(activity, 'flash_bwd_')} [{label}]")
    del params, opt_state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches, [flash_replay(dev, cfg.name, PREFILL_B, PREFILL_S,
                                   cfg.n_heads, cfg.n_kv_heads,
                                   cfg.resolved_head_dim, False, True)]


def nemotron_paged_replay(cfg, dev):
    """The paged kernel at the nemotron serving run's batched call: the
    engine's 4 slots over the page view of its cache (identity table),
    every slot at the run's last position."""
    rng = np.random.default_rng(31)
    slots, max_len = NEMOTRON_SERVE["slots"], NEMOTRON_SERVE["max_len"]
    ps = model_attention.page_size_for(max_len)
    n_pg = max_len // ps
    hd = cfg.resolved_head_dim
    live = NEMOTRON_SYS_LEN + NEMOTRON_USER_LEN + NEMOTRON_NEW - 1
    args = (randn(rng, (slots, cfg.n_heads, hd), torch.bfloat16, dev),
            randn(rng, (slots * n_pg, ps, cfg.n_kv_heads, hd),
                  torch.bfloat16, dev),
            randn(rng, (slots * n_pg, ps, cfg.n_kv_heads, hd),
                  torch.bfloat16, dev),
            torch.arange(slots * n_pg, dtype=torch.int32,
                         device=dev).view(slots, n_pg),
            torch.full((slots,), live, dtype=torch.int32, device=dev))
    return replay_paged(args, "nemotron B=4 batched decode", card_label())


def phase_nemotron(dev, seed):
    """nemotron-4-340b at full width and NEMOTRON_LAYERS layers: the
    prefill (causal flash at D 192, GQA 12) and the engine (the paged
    kernel at D 192), each held against the plain versions; then the
    flash kernels and the paged kernel at its shapes. Returns (launches
    by phase, [(shape, replay rows)])."""
    cfg = dataclasses.replace(get_config(NEMOTRON_ARCH),
                              n_layers=NEMOTRON_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    log(f"model: {cfg.name} at full width, {cfg.n_layers} of 96 layers "
        f"(depth cut: the 96 do not fit one card), d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
        f"{cfg.mlp_type} d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{sum(t.numel() for t in leaves(params))} parameters, random bf16 "
        f"from seed {seed} in {time.perf_counter() - t0:.2f} s")
    launches = {"nemotron-prefill": {"flash_attention_fwd": timed(
        "nemotron-prefill", prefill_check, params, cfg, dev,
        "nemotron-prefill", 24, ARCHS_PREFILL_B)}}
    launches["nemotron-serve"] = {"paged_attention": timed(
        "nemotron-serve", serve_check, params, cfg, dev, "nemotron-serve",
        NEMOTRON_SERVE, NEMOTRON_REQUESTS, NEMOTRON_SYS_LEN,
        NEMOTRON_USER_LEN, NEMOTRON_NEW)[0]}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    paged_shape = (f"{cfg.name} B{NEMOTRON_SERVE['slots']} H{cfg.n_heads}/"
                   f"{cfg.n_kv_heads} D{cfg.resolved_head_dim} serving call")
    return launches, [
        flash_replay(dev, cfg.name, ARCHS_PREFILL_B, PREFILL_S, cfg.n_heads,
                     cfg.n_kv_heads, cfg.resolved_head_dim, True, True),
        (paged_shape, {"paged": nemotron_paged_replay(cfg, dev)})]


def cut_depth(cfg, layers):
    """``cfg`` at its first ``layers`` layers (None: all of them); a cut
    inside the repeating layer pattern keeps that many of its blocks."""
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=layers, layer_pattern=(
        cfg.layer_pattern[:min(layers, cfg.period)]))


def phase_archs(dev, seed):
    """Every architecture no earlier phase ran on the card (``ARCHS``), at
    full width: a prefill at B 1 x S 4096 through the flash kernel and
    an engine run through the paged kernel, each held against the plain
    versions (the MoE models under the routing rule). Returns the
    launches by phase."""
    launches = {}
    for n, (arch, layers) in enumerate(ARCHS.items()):
        cfg = cut_depth(get_config(arch), layers)
        params = init_params(cfg, seed=seed, device=dev)
        log(f"model: {cfg.name} at full width, {cfg.n_layers} of "
            f"{get_config(arch).n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
            f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, "
            f"{sum(t.numel() for t in leaves(params))} parameters, random "
            f"bf16 from seed {seed}")
        launches[f"{arch}-prefill"] = {"flash_attention_fwd": timed(
            f"{arch}-prefill", prefill_check, params, cfg, dev,
            f"{arch}-prefill", 25 + n, ARCHS_PREFILL_B)}
        launches[f"{arch}-serve"] = {"paged_attention": timed(
            f"{arch}-serve", serve_check, params, cfg, dev, f"{arch}-serve",
            ARCHS_SERVE, ARCHS_REQUESTS, ARCHS_SYS_LEN, ARCHS_USER_LEN,
            ARCHS_NEW)[0]}
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- launch --

# Launches in the host-cost stream, and its repeats.
HOST_STREAM, HOST_REPEATS = 20_000, 5
# The placed steps with the AdamW kernels against the same steps with the
# plain update. The first step's loss comes before any update, so it is
# equal, and its grad norm differs only in the order of the fp32 sums
# (within ADAMW_NORM_REL). That difference of a few ulps in the clip
# scale carries on into the later steps (the grad norms 2.9e-3 apart by
# the fourth step on one H100), so the later steps are held to the plain
# update with the kernels' norms replayed into it: its losses equal the
# kernels' bit for bit, as the kernels round as the plain loop does.
ADAMW_NORM_REL = 1e-6


def launch_steps(dev, root, seed, mesh=None):
    """The train phase's timed steps again: its pipeline from ``seed``
    with the gradient check's batch skipped, parameters from ``seed``,
    the same optimizer and ``make_train_step(remat=True)``. With a
    ``mesh`` the parameters, moments and batches are placed by
    ``repro_torch.launch.train`` and the step runs under
    ``implicit_replication``. Returns losses, grad norms, step walls, the
    launches of the steps (counts set to 0 just before them), the kinds
    of parameter and moment and the AdamW kernels' launches a kernel
    update (:func:`adamw_step_launches`)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import train as launcher
    from repro_torch.sharding.partition import make_policy
    cfg = get_config(ARCH)
    pipeline = train_pipeline(root, cfg.vocab_size, seed)
    pipeline.next_batch()
    opt_cfg = OptimizerConfig(peak_lr=3e-4, warmup_steps=2,
                              total_steps=TRAIN_STEPS + 1)
    if mesh is None:
        params = init_params(cfg, seed=seed, device=dev)
        opt_state = adamw_init(params, opt_cfg)
    else:
        policy = make_policy(cfg, mesh)
        params, opt_state = launcher.placed_state(cfg, opt_cfg, seed, mesh,
                                                  policy)
    step = make_train_step(cfg, opt_cfg, remat=True)
    torch.cuda.synchronize()
    losses, gnorms, walls = [], [], []
    zero_launches()
    for _ in range(TRAIN_STEPS):
        batch = on_card(pipeline.next_batch(), dev)
        t = time.perf_counter()
        if mesh is None:
            params, opt_state, metrics = step(params, opt_state, batch)
        else:
            batch = launcher.place_batch(batch, mesh, policy)
            with implicit_replication():
                params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(launcher.scalar(metrics["loss"]))   # synchronizes
        walls.append(time.perf_counter() - t)
        gnorms.append(launcher.scalar(metrics["grad_norm"]))
    launches = step_launches()
    kinds = (type(leaves(params)[0]).__name__,
             type(leaves(opt_state["m"])[0]).__name__)
    per_update = adamw_step_launches(params)
    del params, opt_state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return losses, gnorms, walls, launches, kinds, per_update


@contextlib.contextmanager
def plain_optimizer(norms=None):
    """The train step's AdamW update on its plain version, the rest of
    the step (its attention kernels) as it is; with ``norms`` the i-th
    update takes ``norms[i]`` as its global norm (another run's norms
    replayed)."""
    from repro_torch.train import optimizer as opt_module
    from repro_torch.train import train_step as step_module
    real, real_norm = step_module.adamw_update, opt_module.global_norm
    step_module.adamw_update = lambda *args: real(*args[:6], impl="plain")
    if norms is not None:
        replay = iter(norms)
        opt_module.global_norm = lambda tree: torch.tensor(
            next(replay), dtype=torch.float32, device=leaves(tree)[0].device)
    try:
        yield
    finally:
        step_module.adamw_update = real
        opt_module.global_norm = real_norm


def rel_gap(got, want):
    """Largest relative gap of two lists of numbers."""
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def phase_launch_train(dev, root, seed):
    """llama3.2-3b trained through the launcher's placement on the (1, 1)
    NCCL mesh; held bit for bit to the unplaced steps; the same placed
    steps again with the plain AdamW update, the step before the AdamW
    kernels, held to the kernels' steps as :data:`ADAMW_NORM_REL` says.
    Returns the launches and the median placed step."""
    label = card_label()
    cfg = get_config(ARCH)
    if TRAIN_RUN:
        ref = dict(TRAIN_RUN, source="phase train")
    else:
        losses, gnorms, walls, *_ = launch_steps(dev, root / "unplaced",
                                                 seed)
        ref = dict(losses=losses, grad_norms=gnorms,
                   median_s=float(np.median(walls[1:])),
                   source="unplaced steps run here")
    t0 = time.perf_counter()
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device=dev)
    mesh_s = time.perf_counter() - t0
    losses, gnorms, walls, launches, kinds, per_update = launch_steps(
        dev, root / "placed", seed, mesh)
    want = {"flash_attention_fwd": 2 * cfg.n_layers * TRAIN_STEPS,
            "flash_attention_bwd": cfg.n_layers * TRAIN_STEPS,
            "adamw": TRAIN_STEPS * per_update}
    if launches != want or paged.LAUNCHES["paged_attention"]:
        raise AssertionError(f"launch-train: launches {launches} (want "
                             f"{want}), paged "
                             f"{paged.LAUNCHES['paged_attention']}")
    if kinds != ("DTensor", "DTensor"):
        raise AssertionError(f"launch-train: parameters and moments are "
                             f"{kinds}, not DTensors")
    if losses != ref["losses"] or gnorms != ref["grad_norms"]:
        raise AssertionError(
            f"launch-train: placed losses {losses} and grad norms {gnorms} "
            f"differ from the unplaced {ref['losses']} and "
            f"{ref['grad_norms']} ({ref['source']})")
    med = float(np.median(walls[1:]))
    with plain_optimizer():
        plain_losses, plain_gnorms, plain_walls, plain_launches, *_ = \
            launch_steps(dev, root / "placed_plain", seed, mesh)
    with plain_optimizer(norms=gnorms):
        replay_losses, *_ = launch_steps(dev, root / "placed_replay", seed,
                                         mesh)
    plain_med = float(np.median(plain_walls[1:]))
    plain_want = dict(want, adamw=0)
    norm_gap = rel_gap(gnorms[:1], plain_gnorms[:1])
    log(f"launch-train: the same placed steps with the plain AdamW update:"
        f" losses {plain_losses}, grad norms {plain_gnorms}; launches "
        f"{plain_launches}; first losses equal: "
        f"{plain_losses[0] == losses[0]}, first grad norms {norm_gap:.3e} "
        f"apart (bound {ADAMW_NORM_REL}); later steps apart by "
        f"{rel_gap(losses, plain_losses):.3e} in the losses, "
        f"{rel_gap(gnorms, plain_gnorms):.3e} in the grad norms; with the "
        f"kernels' norms replayed: losses {replay_losses}, equal to the "
        f"kernels' bit for bit: {replay_losses == losses}; step walls "
        f"{[round(w, 6) for w in plain_walls]} s, median {plain_med:.6f} "
        f"s; with the AdamW kernels {med:.6f} s ({med / plain_med:.4f} x) "
        f"[{label}]")
    if plain_launches != plain_want or plain_losses[0] != losses[0] or \
            not norm_gap <= ADAMW_NORM_REL or replay_losses != losses:
        raise AssertionError(
            f"launch-train: the plain AdamW update's steps: launches "
            f"{plain_launches} (want {plain_want}), losses {plain_losses} "
            f"and grad norms {plain_gnorms} against the kernels' {losses} "
            f"and {gnorms} (the first losses equal, the first norms within "
            f"{ADAMW_NORM_REL}); with the kernels' norms replayed, losses "
            f"{replay_losses} (equal)")
    log(f"launch-train: {ARCH} at full width and depth on a "
        f"{tuple(mesh.shape)} {dist.get_backend()} mesh "
        f"{mesh.mesh_dim_names} (made in {mesh_s:.3f} s), parameters and "
        f"moments {kinds[0]}s, B={TRAIN_B} S={TRAIN_S}, 1 warm-up + "
        f"{TRAIN_STEPS - 1} timed steps: losses {losses} and grad norms "
        f"{gnorms} equal the unplaced steps' bit for bit ({ref['source']});"
        f" launches {launches}; step walls {[round(w, 6) for w in walls]} "
        f"s, median {med:.6f} s against the unplaced {ref['median_s']:.6f} "
        f"s: DTensor's host cost on one card {med - ref['median_s']:.6f} s "
        f"a step ({med / ref['median_s']:.4f} x) [{label}]")
    return launches, med


def host_launch_cost(dev):
    """(host s, device s) per launch of a stream of HOST_STREAM tiny
    in-place adds, the medians of HOST_REPEATS repeats: the host clock
    around the enqueue, CUDA events around the device's work."""
    x = torch.zeros(1, device=dev)
    for _ in range(1000):
        x.add_(1)
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(HOST_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        for _ in range(HOST_STREAM):
            x.add_(1)
        host.append((time.perf_counter() - t) / HOST_STREAM)
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end) / 1e3 / HOST_STREAM)
    return float(np.median(host)), float(np.median(device))


def phase_launch_roofline(dev, measured_s):
    """The per-launch host cost, then the analyzer's roofline of the
    launch-train cell on a one-rank fake mesh, held below the measured
    step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape, mesh_over_group
    from repro_torch.launch.op_analysis import OpAnalyzer
    from repro_torch.launch.roofline import H100, build_report, format_row
    from repro_torch.sharding.partition import axis_sizes
    label = card_label()
    host_s, device_s = host_launch_cost(dev)
    log(f"launch-roofline: host cost of one launch {host_s * 1e6:.4f} us "
        f"(host clock over {HOST_STREAM} tiny adds, median of "
        f"{HOST_REPEATS}), the device's time a launch "
        f"{device_s * 1e6:.4f} us (CUDA events); roofline.H100.loop_latency "
        f"{H100.loop_latency * 1e6:.4f} us [{label}]")
    dist.destroy_process_group()      # the launch-train NCCL group
    dryrun.fake_world(1)
    mesh = mesh_over_group(MeshShape(("data", "model"), (1, 1)))
    cfg = get_config(ARCH)
    shape = ShapeConfig(f"train_b{TRAIN_B}_s{TRAIN_S}", "train", TRAIN_S,
                        TRAIN_B)
    analyzer = OpAnalyzer(mesh)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        ma = dryrun.lower_cell(cfg, shape, mesh, analyzer)
    lower_s = time.perf_counter() - t0
    hw = dataclasses.replace(H100, loop_latency=host_s)
    rep = build_report(ARCH, shape, "1x1", 1, analyzer.cost, cfg, hw=hw,
                       axis_sizes=axis_sizes(mesh))
    dist.destroy_process_group()
    log(f"launch-roofline: {format_row(rep)}")
    log(f"launch-roofline: per chip {rep.flops_per_chip:.6e} flops, "
        f"{rep.bytes_per_chip:.6e} bytes, {rep.seq_iters:.0f} launches, "
        f"{rep.coll_bytes_per_chip:.6e} collective bytes; terms compute "
        f"{rep.compute_s:.6f} s, memory {rep.memory_s:.6f} s, collective "
        f"{rep.collective_s:.6f} s, serial {rep.serial_s:.6f} s; "
        f"bottleneck {rep.bottleneck}, useful_ratio {rep.useful_ratio:.6f},"
        f" roofline_fraction {rep.roofline_fraction:.6f}; roofline step "
        f"{rep.step_time_s:.6f} s, measured median step {measured_s:.6f} s "
        f"= {measured_s / rep.step_time_s:.4f} x the roofline; argument "
        f"bytes {ma['argument_bytes']}; analysis {lower_s:.2f} s on the "
        f"host [{label}]")
    if not (rep.compute_s <= measured_s and rep.memory_s <= measured_s):
        raise AssertionError(
            f"launch-roofline: a roofline term above the measured step "
            f"{measured_s} s: compute {rep.compute_s} s, memory "
            f"{rep.memory_s} s (the count is wrong)")
    return rep


def phase_launch(dev, seed):
    """The launch group: launch-train, then launch-roofline. It runs last
    and imports the launch layer itself: ``torch.distributed.tensor``
    slows the eager dispatch of plain tensors once imported
    (``repro_torch.sharding.local``), and the other groups time
    host-bound steps."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as tmp:
        launches, med = timed("launch-train", phase_launch_train, dev,
                              Path(tmp), seed)
    timed("launch-roofline", phase_launch_roofline, dev, med)
    return launches


# ------------------------------------------------------------- adamw
#
# The AdamW kernels (kernels/adamw) on the two trees the port trains on the
# card: the benchmark cell's deepseek-moe-16b (4 of 28 layers, 55 leaves:
# bf16 weights, fp32 routers and norm scales) and llama3.2-3b at full
# size (254 leaves).

ADAMW_TREES = (("deepseek-moe-16b", 4), (ARCH, None))
# The benchmark cell's schedule; the state is drawn as after some steps.
ADAMW_OPT = dict(peak_lr=1e-3, warmup_steps=10, total_steps=1000)
ADAMW_REPS = 10
ADAMW_SRC = "src/repro_torch/kernels/adamw/adamw.cu"
ADAMW_REPLACES = ("none: src/repro/train/optimizer.py:59 adamw_update is "
                  "plain JAX, fused by XLA")


def adamw_tree(arch, layers, dev, seed):
    """(cfg, params, grads, AdamW state, decay mask) of ``arch`` cut to
    ``layers``: parameters from ``seed``, gradients and moments drawn from
    it (moments as after some steps: nonzero, v > 0)."""
    cfg = cut_depth(get_config(arch), layers)
    params = init_params(cfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)

    def draw(t, scale):
        return torch.randn(t.shape, generator=gen, device=dev,
                           dtype=t.dtype).mul_(scale)

    grads = tree_map(lambda p: draw(p, 1e-3), params)
    state = adamw_init(params, OptimizerConfig(**ADAMW_OPT))
    for m, v in zip(leaves(state["m"]), leaves(state["v"])):
        m.copy_(draw(m, 1e-4))
        v.copy_(draw(v, 1e-4).square_())
    return cfg, params, grads, state, reference_decay_mask(params)


def bits_digest(t):
    """A checksum of ``t``'s bits, a 0-dim int64 on its device: each
    element's bit pattern times (its index mod 65521) + 1, summed (with
    wraparound) in chunks of 2^24 elements."""
    flat = t.reshape(-1).view({torch.bfloat16: torch.int16,
                               torch.float32: torch.int32}[t.dtype])
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for i0 in range(0, flat.numel(), 1 << 24):
        part = flat[i0:i0 + (1 << 24)].to(torch.int64)
        w = torch.arange(i0, i0 + part.numel(), device=t.device) % 65521 + 1
        total += (part * w).sum()
    return total


def adamw_tree_check(params, grads, state, mask, opt_cfg):
    """``adamw_update`` with the kernels over the whole tree, as the
    train step calls it (every batch, leaf table and decay flag of that
    call), against the plain version leaf by leaf from the same start,
    and a second kernel run from that start equal bit for bit (per-leaf
    :func:`bits_digest` of p, m and v). The start is kept on the host;
    the tree is left at the kernels' update. Returns (largest gap of p,
    m, v over the bound; largest relative gap of a leaf's sum of
    squares)."""
    ps, gs, ms, vs = (leaves(t) for t in (params, grads, state["m"],
                                            state["v"]))
    start = [[t.to("cpu", copy=True) for t in leaf]
             for leaf in zip(ps, ms, vs)]
    sums = kadamw.sum_squares(gs)
    plain_sums = sum_squares(gs)
    sum_gap = float(((sums - plain_sums).abs()
                     / plain_sums.clamp(min=1e-30)).max())
    count, lr, scale, bc1, bc2 = step_scalars(
        opt_cfg, state["count"], torch.sqrt(torch.sum(plain_sums)))
    digests = []
    for run in range(2):
        if run:
            for leaf, host in zip(zip(ps, ms, vs), start):
                for t, h in zip(leaf, host):
                    t.copy_(h)
        adamw_update(params, grads, dict(state), opt_cfg, mask,
                     impl="kernel")
        digests.append(torch.stack([torch.stack([bits_digest(t)
                                                 for t in leaf])
                                    for leaf in zip(ps, ms, vs)]).cpu())
    differ = (digests[0] != digests[1]).any(dim=1).nonzero().flatten()
    if len(differ):
        raise AssertionError(f"adamw: two kernel runs over the tree "
                             f"differ in the bits of leaves "
                             f"{differ.tolist()}")
    worst = 0.0
    for i, dk in enumerate(leaves(mask)):
        p, m, v = (h.to(ps[i].device) for h in start[i])
        update_leaf(p, gs[i], m, v, dk, scale, lr, bc1, bc2, opt_cfg)
        for got, want in zip((ps[i], ms[i], vs[i]), (p, m, v)):
            worst = max(worst, close_ratio(got, want))
        del p, m, v
    return worst, sum_gap


def close_ratio(got, want):
    """max |got - want| over the card test's bound (one ulp of a bf16
    value, 1e-6 of an fp32 one, at least 1e-6 of the largest |want|); at
    most 1 passes, a NaN reads as infinite."""
    g, w = got.float(), want.float()
    floor = 1e-6 * float(w.abs().max())
    if want.dtype == torch.bfloat16:
        bound = torch.exp2(torch.floor(torch.log2(w.abs())) - 7)
    else:
        bound = 1e-6 * w.abs()
    diff = (g - w).abs()
    ratio = torch.where(diff == 0, torch.zeros_like(diff),
                        diff / torch.clamp(bound, min=floor))
    return float(torch.nan_to_num(ratio, nan=float("inf")).max())


def fused_adamw_ms(ps, gs, ms, vs, opt_cfg):
    """``torch._fused_adamw_``'s time over the same leaves (the yardstick
    only: the port never calls it), one call per parameter dtype as
    ``torch.optim`` groups them, without clipping. It takes moments only
    in the parameters' dtype, so bf16 leaves run with bf16 copies of
    theirs (14 bytes a parameter moved, not 24)."""
    dev = ps[0].device
    groups = {}
    for i, p in enumerate(ps):
        groups.setdefault(p.dtype, []).append(i)
    ms = [m.to(p.dtype) for m, p in zip(ms, ps)]
    vs = [v.to(p.dtype) for v, p in zip(vs, ps)]
    steps = [torch.ones((), dtype=torch.float32, device=dev) for _ in ps]

    def run():
        for idx in groups.values():
            torch._fused_adamw_(
                [ps[i] for i in idx], [gs[i] for i in idx],
                [ms[i] for i in idx], [vs[i] for i in idx], [],
                [steps[i] for i in idx], lr=opt_cfg.peak_lr,
                beta1=opt_cfg.b1, beta2=opt_cfg.b2,
                weight_decay=opt_cfg.weight_decay, eps=opt_cfg.eps,
                amsgrad=False, maximize=False)

    return cuda_ms(run, ADAMW_REPS)


def adamw_bytes(params, grads, state):
    """Bytes the fused update must move: each gradient read twice (the
    norm, the update), each parameter and moment read and written."""
    return sum(2 * (t.numel() * t.element_size())
               for tree in (params, grads, state["m"], state["v"])
               for t in leaves(tree))


def phase_adamw(dev, seed, train_launches=None):
    """The AdamW kernels at each tree of :data:`ADAMW_TREES`: the whole
    tree's kernel update against the plain version and twice bit for bit
    (:func:`adamw_tree_check`), then ``adamw_update`` timed whole with
    the kernels and with the plain version, the norm's kernels alone and
    ``torch._fused_adamw_``; launches an update and the bound (the bytes
    of :func:`adamw_bytes` at 3.35 TB/s). Returns the kernels JSON row:
    the first tree's numbers (every tree's under ``shapes``), its
    ``launches`` those of moe-train's timed steps (``train_launches``,
    the main path's count; None where the moe group did not run)."""
    label = card_label()
    opt_cfg = OptimizerConfig(**ADAMW_OPT)
    rows = {}
    for arch, layers in ADAMW_TREES:
        cfg, params, grads, state, mask = adamw_tree(arch, layers, dev,
                                                     seed)
        decay = leaves(mask)
        n = sum(p.numel() for p in leaves(params))
        worst, sum_gap = adamw_tree_check(params, grads, state, mask,
                                          opt_cfg)
        if worst > 1.0 or sum_gap > 1e-5:
            raise AssertionError(f"adamw: {arch}: kernel against plain "
                                 f"gap {worst} of the bound, sums of "
                                 f"squares {sum_gap} relative")
        held = dict(state)

        def update(impl):
            _, new, _ = adamw_update(params, grads, held, opt_cfg, mask,
                                     impl=impl)
            held["count"] = new["count"]

        before = kadamw.LAUNCHES["adamw"]
        update("kernel")
        launches = kadamw.LAUNCHES["adamw"] - before
        ms = cuda_ms(lambda: update("kernel"), ADAMW_REPS)
        norm_ms = cuda_ms(lambda: kadamw.sum_squares(leaves(grads)),
                          ADAMW_REPS)
        plain_ms = cuda_ms(lambda: update("plain"), 3)
        lib_ms = fused_adamw_ms(leaves(params), leaves(grads),
                                leaves(held["m"]), leaves(held["v"]),
                                opt_cfg)
        nbytes = adamw_bytes(params, grads, state)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows[f"{arch} {cfg.n_layers} layers"] = dict(
            leaves=len(decay), params=n, update_launches=launches, ms=ms,
            norm_ms=norm_ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by="bytes",
            bytes=nbytes, max_gap=worst, sum_gap=sum_gap)
        log(f"adamw: {arch} at {cfg.n_layers} layers, {len(decay)} leaves, "
            f"{n} parameters: the whole tree's kernel update within "
            f"{worst:.4f} of its bound of the plain version in every leaf "
            f"and equal bit for bit on a second run, sums of squares within"
            f" {sum_gap:.3e}; adamw_update "
            f"{ms:.4f} ms ({launches} launches; the norm's {norm_ms:.4f} "
            f"ms), plain {plain_ms:.4f} ms, torch._fused_adamw_ "
            f"{lib_ms:.4f} ms (moments in the parameters' dtype, no "
            f"clipping); "
            f"bound {bound_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s, "
            f"{nbytes / n:.2f} a parameter): {bound_ms / ms * 100:.2f} % "
            f"of it [{label}]")
        del params, grads, state, held, mask
        gc.collect()
        torch.cuda.empty_cache()
    first = next(iter(rows.values()))
    return {"name": "adamw", "route": "cuda", "source": ADAMW_SRC,
            "replaces": ADAMW_REPLACES, "launches": train_launches,
            "max_abs_err": None, "max_gap": max(r["max_gap"]
                                                for r in rows.values()),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": "bytes",
            "library_ms": first["library_ms"], "shapes": rows,
            "earlier": "PERF.md §6"}


# ------------------------------------------------------------- gates
#
# The caching engine's CI gates (tools/smoke_torch.py) on the card, each
# held to its own plain run, then the port's examples and the serving
# launcher at their defaults.

REPO = Path(__file__).resolve().parent
# What each gate's log line prints from its checked run's summary.
GATE_COUNTERS = {
    "artifact_counters": ("artifact_hits", "artifact_misses"),
    "bitmap_prune": ("block_pairs_evaluated", "block_pairs_total",
                     "block_pairs_bitmap_killed"),
    "mqo": ("mqo_tasks_total", "mqo_tasks_executed", "mqo_shared_hits",
            "result_cache_hits"),
    "trace": ("reuse_hits", "mqo_shared_hits", "result_cache_hits",
              "replica_hits"),
    "failover": ("failover_readmits", "replica_hits"),
    "chaos": ("faults_injected", "retries", "transfer_reroutes",
              "raw_fallbacks", "checksum_mismatch", "degraded_queries",
              "audit_violations"),
    "audit": ("faults_injected", "retries", "degraded_queries",
              "audit_violations"),
}
# The examples: (script, arguments past ``--device``, the kernel its
# main must launch). The analytics query (the reference's own) touches no
# cell, so no join runs; train_lm's 128 tokens take the naive attention
# path (as the reference's "auto" does below 2048), so it launches no
# ported kernel. It keeps 20 steps: after 5 its own check (the last loss
# below the first) failed on the card.
EXAMPLES = (("examples/quickstart_torch.py", [], "simjoin_block_counts"),
            ("examples/raw_array_analytics_torch.py", [], None),
            ("examples/serve_lm_torch.py", [], "paged_attention"),
            ("examples/train_lm_torch.py", ["--steps", "20"], None))
# The serving launcher's command line at its defaults (reduced
# qwen1.5-0.5b, head dim 16), as ``python -m repro_torch.launch.serve``
# gets it.
LAUNCHER_ARGV = ["repro_torch.launch.serve"]


def load_script(rel):
    """A script of the repo (``tools/``, ``examples/``) as a module."""
    import importlib.util
    path = REPO / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def attention_launches():
    """The attention kernels' launch counts so far."""
    return {**flash.LAUNCHES, **paged.LAUNCHES}


def gate_on_card(smoke, dev, tag, gate, **kw):
    """One gate through the CUDA kernels (simjoin launch counts set to 0
    just before and read just after), then through their plain versions
    on the card: both pass, and every run's per-query matches and
    non-timing summary keys are equal (chaos: its storm's schedule too).
    Returns the kernel run's launches."""
    for name in simjoin.LAUNCHES:
        simjoin.LAUNCHES[name] = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gate_") as tmp:
        t0 = time.perf_counter()
        got = smoke.GATES[gate](backend="torch_device", device=dev.type,
                                root=tmp, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(simjoin.LAUNCHES)
        t0 = time.perf_counter()
        plain = smoke.GATES[gate](backend="torch_device", device=dev.type,
                                  impl="plain", root=tmp, **kw)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
    for run in (got, plain):
        if not run.ok:
            raise AssertionError(f"gates[{tag}] failed: {run.failures}")
    for name, run in got.runs.items():
        other = plain.runs[name]
        if run.matches != other.matches:
            raise AssertionError(f"gates[{tag}] {name}: matches "
                                 f"{run.matches} vs plain {other.matches}")
        if non_timing(run.summary) != non_timing(other.summary):
            raise AssertionError(f"gates[{tag}] {name}: summary "
                                 f"{run.summary} vs plain {other.summary}")
    if got.extra.get("schedule_log") != plain.extra.get("schedule_log"):
        raise AssertionError(f"gates[{tag}]: storm schedules differ")
    checked = list(got.runs.values())[-1]
    counters = {k: checked.summary.get(k) for k in GATE_COUNTERS[gate]}
    counters.update({k: v for k, v in got.extra.items()
                     if k in ("coverage", "engaged", "replicated",
                              "victim", "audits_run")})
    log(f"gates[{tag}]: OK, {wall:.2f} s (plain {plain_wall:.2f} s), "
        f"{len(got.runs)} runs equal to plain, matches "
        f"{sum(m or 0 for m in checked.matches)} over "
        f"{len(checked.matches)} queries, {counters}, launches {launches} "
        f"[{card_label()}]")
    return launches


def d16_replays(dev):
    """The attention kernels at head dim 16, every reduced config's: the
    flash forward and backward at a reduced config's heads (4 / 4) over
    B 2 x S 4096, causal, and the paged kernel at the serving launcher's
    batched call (4 slots, max_len 128, 4 / 4 heads, 72 live positions
    a slot), each against its plain version and timed beside SDPA and
    its bound. Returns [(shape, replay rows)]."""
    cfg = reduced(get_config("qwen1.5-0.5b"))
    hd = cfg.resolved_head_dim
    out = [flash_replay(dev, "reduced D16", 2, PREFILL_S, cfg.n_heads,
                        cfg.n_kv_heads, hd, True, backward=True)]
    rng = np.random.default_rng(32)
    slots, max_len = 4, 128
    ps = model_attention.page_size_for(max_len)
    n_pg = max_len // ps
    args = (randn(rng, (slots, cfg.n_heads, hd), torch.bfloat16, dev),
            randn(rng, (slots * n_pg, ps, cfg.n_kv_heads, hd),
                  torch.bfloat16, dev),
            randn(rng, (slots * n_pg, ps, cfg.n_kv_heads, hd),
                  torch.bfloat16, dev),
            torch.arange(slots * n_pg, dtype=torch.int32,
                         device=dev).view(slots, n_pg),
            torch.full((slots,), 72, dtype=torch.int32, device=dev))
    kind = f"reduced D16 B={slots} batched decode"
    out.append((kind, {"paged": replay_paged(args, kind, card_label())}))
    return out


def phase_gates(dev):
    """Every gate at its tool's size, failover and chaos again on the
    paper's PTF deployment, then the examples and the serving launcher
    on the card, then the attention kernels timed at head dim 16.
    Returns the launches of every kernel over the group's kernel runs
    (the timing replays not counted) and the replays."""
    smoke = load_script("tools/smoke_torch.py")
    total = {name: 0 for name in simjoin.LAUNCHES}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    for gate in smoke.GATES:
        add(gate_on_card(smoke, dev, gate, gate))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gates_ptf_") as tmp:
        t0 = time.perf_counter()
        ptf = smoke.PTF.build(tmp)
        cells = sum(f.n_cells for f in ptf.catalog.files)
        log(f"gates[ptf]: {len(ptf.catalog.files)} files, {cells} cells, "
            f"{ptf.deployment.n_nodes} nodes, generate + write "
            f"{time.perf_counter() - t0:.2f} s")
        add(gate_on_card(smoke, dev, "failover ptf", "failover",
                         dataset=ptf))
        add(gate_on_card(smoke, dev, "chaos ptf", "chaos", dataset=ptf,
                         fail_half=True))
    if any(total[name] == 0 for name in simjoin.LAUNCHES):
        raise AssertionError(f"gates: a simjoin kernel never launched: "
                             f"{total}")

    on = ["--device", dev.type]
    for rel, argv, kernel in EXAMPLES:
        before = {**attention_launches(), **simjoin.LAUNCHES}
        t0 = time.perf_counter()
        load_script(rel).main(on + argv)
        torch.cuda.synchronize()
        ran = {k: v - before[k]
               for k, v in {**attention_launches(),
                            **simjoin.LAUNCHES}.items()}
        if kernel is not None and not ran[kernel]:
            raise AssertionError(f"{rel} never launched {kernel}: {ran}")
        add(ran)
        log(f"gates[{Path(rel).stem}]: main({on + argv}) on the card, "
            f"{time.perf_counter() - t0:.2f} s, launches {ran}"
            + ("" if kernel else " (no ported kernel on its path)"))
    # ``python -m repro_torch.launch.serve``, run in this process (a
    # raise fails the phase, as a nonzero exit would).
    import runpy
    before = attention_launches()
    argv, sys.argv = sys.argv, list(LAUNCHER_ARGV)
    t0 = time.perf_counter()
    try:
        runpy.run_module("repro_torch.launch.serve", run_name="__main__",
                         alter_sys=True)
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in attention_launches().items()}
    add(ran)
    if not ran["paged_attention"]:
        raise AssertionError(f"the serving launcher never launched the "
                             f"paged kernel: {ran}")
    log(f"gates[launch.serve]: python -m repro_torch.launch.serve at its "
        f"defaults (reduced qwen1.5-0.5b, head dim 16) ran to its end in "
        f"{time.perf_counter() - t0:.2f} s; launches {ran}")
    return {k: v for k, v in total.items() if v}, d16_replays(dev)


class BackgroundBuild:
    """``build_all(libraries)`` on a thread, started at once. :meth:`wait`
    joins it (so no nvcc outlives the script) and raises its error;
    ``seconds`` is then the build's wall from the start."""

    def __init__(self, libraries):
        self.seconds = None
        self.error = None
        t0 = time.perf_counter()

        def run():
            try:
                build_all(libraries)
            except BaseException as exc:     # raised again by wait()
                self.error = exc
            self.seconds = time.perf_counter() - t0

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def wait(self):
        """Wait for the build; raise what it raised."""
        self.thread.join()
        if self.error is not None:
            raise self.error


def log_build(libraries):
    """Each built library's nvcc seconds, path and ptxas lines."""
    for lib in libraries:
        log(f"build: {lib.source.name} {lib.info['seconds']:.2f} s "
            f"(built={lib.info['built']}) -> {lib.info['path']}")
        for line in str(lib.info["ptxas"]).splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "C7512")):
                log(f"build: {line.strip()}")


# ---------------------------------------------------------------- mla --

# Latent attention: moonlight-16b-a3b as its benchmark cell runs it
# (portbench's moonlight-16b-a3b.train): B x S a step, the experts this
# chip holds and its rows of the vocabulary.
MLA_ARCH = "moonlight-16b-a3b"
MLA_B, MLA_S = 2, 8192
MLA_HELD, MLA_VOCAB = 8, 20480


def phase_mla(dev, root, seed):
    """The bf16 flash kernels at each (q/k, value) head-dim pair of
    ``flash.HEAD_DIM_PAIRS`` against their plain versions: the forward
    on FWD_EDGES and the backward on BWD_EDGES, then both at
    moonlight-16b-a3b's call in its cell (B 2 x S 8192, 16 / 16 heads,
    causal), timed with CUDA events beside the plain versions; then one
    training step of the model as the cell cuts it (8 of 64 experts
    held, vocab 20,480; every width and all 27 layers) on a batch of
    that shape from the raw-array pipeline, whose flash launches are
    held to 2 a layer forward (remat) and 1 backward. Returns the step's launches
    and the cell call's replay rows (``REPLAY_KERNEL`` parts)."""
    rng = np.random.default_rng(16)
    err = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0}
    cases = 0
    for d, dv in flash.HEAD_DIM_PAIRS:
        for b, sq, sk, h, hk, causal, off in FWD_EDGES:
            e = fwd_case(rng, dev, b, sq, sk, h, hk, d, causal, off, dv)
            err["flash_attention_fwd"] = max(err["flash_attention_fwd"], e)
            cases += 1
        for b, sq, sk, h, hk, causal, off in BWD_EDGES:
            e, _ = bwd_case(rng, dev, b, sq, sk, h, hk, d, torch.bfloat16,
                            causal, off, dv)
            err["flash_attention_bwd"] = max(err["flash_attention_bwd"], e)
            cases += 1
    log(f"mla: {cases} edge cases at (q/k, value) head dims "
        f"{flash.HEAD_DIM_PAIRS} (bf16): kernel == plain within 2e-2 "
        f"(forward) / {BWD_TOL[torch.bfloat16]} x max |g| (backward), "
        f"forward lse == plain, backward bits equal run to run, "
        f"max_abs_err {err}")

    # The cell's cut of the model: one chip's 8 of the 64 experts and its
    # eighth of the vocabulary.
    cfg = get_config(MLA_ARCH)
    cfg = dataclasses.replace(cfg, vocab_size=MLA_VOCAB,
                              moe=dataclasses.replace(cfg.moe,
                                                      n_held=MLA_HELD))
    d, dv = cfg.attention_dims
    h, b, s = cfg.n_heads, MLA_B, MLA_S
    shape = f"{MLA_ARCH}: B {b} x S {s} x {h} / {h} x D {d}, DV {dv}, causal"
    e_bwd, (q, k, v, out, lse, dout) = bwd_case(
        rng, dev, b, s, s, h, h, d, torch.bfloat16, True, 0, dv)
    want = attention_ref(q, k, v, causal=True)
    e_fwd = close(out, want, 2e-2, 2e-2, f"flash fwd {shape}")
    del want
    err["flash_attention_fwd"] = max(err["flash_attention_fwd"], e_fwd)
    err["flash_attention_bwd"] = max(err["flash_attention_bwd"], e_bwd)
    torch.cuda.empty_cache()
    live_pairs = b * h * s * (s + 1) // 2
    rows = {}
    for part, flops, kernel, plain in (
            ("fwd", 2 * (d + dv) * live_pairs,
             lambda: flash.flash_attention_fwd(q, k, v, causal=True, bq=1,
                                               bk=1, return_lse=True),
             lambda: attention_ref(q, k, v, causal=True, return_lse=True)),
            ("bwd", 4 * (d + dv) * live_pairs,
             lambda: flash.flash_attention_bwd(q, k, v, out, lse, dout,
                                               causal=True),
             lambda: attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=True))):
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, reps=2)
        torch.cuda.empty_cache()
        bound_ms = flops / BF16_FLOPS_PER_S * 1e3
        name = REPLAY_KERNEL[part]
        rows[part] = {"max_abs_err": err[name], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": "operations",
                      "roofline": 100 * bound_ms / ms}
        log(f"mla: {name} at {shape}: {ms:.4f} ms (CUDA events, 10 back to "
            f"back), plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
            f"(operations: {flops // live_pairs // (d + dv)} (D + DV) a live "
            f"pair at {BF16_FLOPS_PER_S:.3e}), {100 * bound_ms / ms:.2f} % "
            f"of it; {card_label()}")
    del q, k, v, out, lse, dout
    gc.collect()
    torch.cuda.empty_cache()

    pipeline = train_pipeline(root, cfg.vocab_size, seed, batch=b, seq=s)
    params = init_params(cfg, seed=seed, device=dev)
    opt_cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=10,
                              total_steps=1000)
    opt_state = adamw_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, remat=True)
    batch = on_card(pipeline.next_batch(), dev)
    torch.cuda.synchronize()
    zero_launches()
    t = time.perf_counter()
    params, opt_state, metrics = step(params, opt_state, batch)
    loss = float(metrics["loss"])
    wall = time.perf_counter() - t
    launches = step_launches()
    want = {"flash_attention_fwd": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}
    if not math.isfinite(loss) or any(launches[n] != want[n] for n in want):
        raise AssertionError(f"mla: {MLA_ARCH} train step: loss {loss}, "
                             f"launches {launches}, want {want}")
    log(f"mla: {MLA_ARCH} at full width ({cfg.n_layers} layers, "
        f"{cfg.moe.n_held} of {cfg.moe.n_experts} experts held, vocab "
        f"{cfg.vocab_size}, "
        f"{sum(t.numel() for t in leaves(params))} parameters) trained one "
        f"step at B {b} x S {s} from the raw-array pipeline with remat: "
        f"loss {loss:.4f}, {wall:.2f} s (the first step), launches "
        f"{launches}; peak {torch.cuda.max_memory_allocated(dev)} bytes")
    del params, opt_state, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return launches, [(shape, rows)]


def main(argv=None) -> int:
    """Run every phase; any failure raises and exits non-zero."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptf-cells", type=int, default=50_000,
                    help="mean cells per PTF file of the main path "
                         "(prune='auto')")
    ap.add_argument("--ptf-full-cells", type=int, default=100_000,
                    help="mean cells per PTF file of the full-size run "
                         "(prune='block')")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the train phases' corpus and weights")
    ap.add_argument("--phases", default=",".join(PHASE_GROUPS),
                    help="comma-separated phase groups to run (default: "
                         "all): " + ", ".join(PHASE_GROUPS))
    args = ap.parse_args(argv)
    groups = set(args.phases.split(","))
    if not groups <= set(PHASE_GROUPS):
        ap.error(f"unknown phase groups {sorted(groups - set(PHASE_GROUPS))}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    label = card_label()
    log(f"device: {label}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    dev = torch.device("cuda", 0)

    # All five sources start building at once; the join group needs only
    # simjoin.cu, so the attention and AdamW sources build while it runs.
    attention_libs = (flash.LIBRARY, flash.LIBRARY_BWD, paged.LIBRARY,
                      kadamw.LIBRARY)
    background = BackgroundBuild(attention_libs)
    record = []
    rows = []
    try:
        t0 = time.perf_counter()
        build_all((simjoin.LIBRARY,))
        log(f"build: simjoin.cu ready in {time.perf_counter() - t0:.2f} s; "
            f"the {len(attention_libs)} other sources go on building "
            f"(one nvcc each, in parallel) while the join group runs")
        log_build((simjoin.LIBRARY,))
        if "join" in groups:
            t0 = time.perf_counter()
            sweep_err = phase_kernels(dev)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                root = Path(tmp)
                phase_geo(root)
                launches, largest, _ = phase_ptf(
                    root, "ptf", args.ptf_cells, "auto", main_path=True)
                phase_ptf(root, "ptf-full", args.ptf_full_cells, "block",
                          main_path=False)
            rows = replay(largest)
            log(f"group join: {time.perf_counter() - t0:.2f} s")
    finally:
        t0 = time.perf_counter()
        background.thread.join()     # no nvcc outlives a failed group
    background.wait()
    log(f"build: the other sources built in {background.seconds:.2f} s "
        f"from the start (waited {time.perf_counter() - t0:.2f} s for them "
        f"after the join group)")
    log_build(attention_libs)
    fl = flash.LIBRARY.load()
    log("build: flash dynamic shared memory per CTA: " + ", ".join(
        f"{name} D={d} {fl.flash_smem_bytes(code, d)} bytes"
        for code, name in ((1, "flash_fwd_bf16_kernel"),
                           (0, "flash_fwd_f32_kernel"))
        for d in flash.HEAD_DIMS))
    fb = flash.LIBRARY_BWD.load()
    log("build: flash backward dynamic shared memory per CTA: " + ", ".join(
        f"{name} D={d} {fb.flash_bwd_smem_bytes(code, which, d)} bytes"
        for code, which, name in (
            (1, 0, "flash_bwd_dkdv_wgmma_kernel"),
            (1, 1, "flash_bwd_dq_wgmma_kernel"),
            (0, 0, "flash_bwd_dkdv_kernel"), (0, 1, "flash_bwd_dq_kernel"))
        for d in flash.HEAD_DIMS))
    for row in rows:
        name = row["name"]
        record.append({
            "name": name, "route": "cuda", "source": KERNEL_SRC,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(row["max_abs_err"], sweep_err[name]),
            "ms": row["ms"], "graph_ms": row["graph_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "earlier": "PERF.md §6"})

    # The training and later phases' launches ({phase: {kernel:
    # launches}}) and the kernels' replays at model shapes ({kernel:
    # {shape: row}}).
    phase_launches, shapes = {}, {}
    if "attn" in groups:
        record += timed("group attn", attention_rows, dev)
    if "train" in groups:
        train_record, phase_launches["train"] = timed(
            "group train", train_rows, dev, args.seed)
        record += train_record

    def file_replays(replays):
        for shape, parts in replays:
            for part, row in parts.items():
                shapes.setdefault(REPLAY_KERNEL[part], {})[shape] = row

    if "moe" in groups:
        launches, replays = phase_moe(dev, args.seed)
        phase_launches.update(launches)
        file_replays(replays)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as tmp:
            phase_launches["moe-train"] = timed(
                "moe-train", phase_moe_train, dev, Path(tmp), args.seed)
    if "ssm" in groups:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ssm_") as tmp:
            timed("ssm", phase_ssm, dev, Path(tmp), args.seed)
    if "jamba" in groups:
        phase_launches.update(phase_jamba(dev))
    for group, phase in (("hubert", phase_hubert),
                         ("nemotron", phase_nemotron)):
        if group in groups:
            launches, replays = timed(f"group {group}", phase, dev,
                                      args.seed)
            phase_launches.update(launches)
            file_replays(replays)
    if "archs" in groups:
        phase_launches.update(timed("group archs", phase_archs, dev,
                                    args.seed))
    if "adamw" in groups:
        moe_launches = phase_launches.get("moe-train", {})
        record.append(timed("group adamw", phase_adamw, dev, args.seed,
                            moe_launches.get("adamw")))
    if "launch" in groups:
        phase_launches["launch-train"] = timed("group launch", phase_launch,
                                               dev, args.seed)
    if "gates" in groups:
        phase_launches["gates"], replays = timed("group gates", phase_gates,
                                                 dev)
        file_replays(replays)
    if "mla" in groups:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mla_") as tmp:
            phase_launches["moonlight-train"], replays = timed(
                "group mla", phase_mla, dev, Path(tmp), args.seed)
        file_replays(replays)
        for name in ("flash_attention_fwd", "flash_attention_bwd"):
            if not any(row["name"] == name for row in record):
                record.append({"name": name, "route": "cuda",
                               "source": SOURCES[name],
                               "replaces": REPLACES[name],
                               "earlier": "PERF.md §6"})
    for row in record:
        name = row["name"]
        per_phase = {phase: counts[name]
                     for phase, counts in phase_launches.items()
                     if counts.get(name)}
        if per_phase:
            row["phase_launches"] = per_phase
        if shapes.get(name):
            row["shapes"] = shapes[name]
    log(f"total: {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"kernels": record}))
    print(card_label())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def attention_rows(dev):
    """The serving slice's phases (attention kernels, prefill, serve,
    replay); returns their kernels JSON rows."""
    attn_err = phase_attention_kernels(dev)
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"model: {ARCH} at full size, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"{n_params} parameters ({sum(t.nbytes for t in leaves(params))} "
        f"bytes), random bf16 from seed 0 in "
        f"{time.perf_counter() - t0:.2f} s")
    attn_launches = {"flash_attention_fwd": prefill_check(
        params, cfg, dev, "prefill", 13)}
    attn_launches["paged_attention"], calls, paged_args = serve_check(
        params, cfg, dev, "serve", SERVE, SERVE_REQUESTS, SYS_LEN, USER_LEN,
        NEW_TOKENS, probe_pos=REPLAY_PROBE_POS)
    serve_windows(params, cfg, dev, calls)
    del calls
    # The serving phase's engines reach the parameters through reference
    # cycles (their decode step is wrapped by the recorders): collect them
    # so the parameters are freed before the train phase.
    del params
    gc.collect()
    torch.cuda.empty_cache()
    attn_rows = phase_attention_replay(dev, paged_args)
    record = []
    for name, row in attn_rows.items():
        extra = {k: row[k] for k in ("graph_ms", "splits", "b1_ms",
                                     "b1_graph_ms", "b1_splits") if k in row}
        record.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": attn_launches[name],
            "max_abs_err": max(row["max_abs_err"], attn_err[name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], **extra,
            "earlier": "PERF.md §6"})
    return record


def train_rows(dev, seed):
    """The training slice's phases (backward kernels, train, backward
    replay, resume); returns the backward's kernels JSON row and the
    train phase's launches."""
    bwd_err = phase_train_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = Path(tmp)
        train_launches = phase_train(dev, root / "full", seed)
        row = phase_train_replay(dev)
        phase_resume(dev, root / "resume", seed)
    name = "flash_attention_bwd"
    return [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": train_launches[name],
        "max_abs_err": max(row["max_abs_err"], bwd_err), "ms": row["ms"],
        "graph_ms": row["graph_ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "train_fwd_launches": train_launches["flash_attention_fwd"],
        "earlier": "PERF.md §6"}], train_launches


if __name__ == "__main__":
    sys.exit(main())
