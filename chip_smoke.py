#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds every kernel library from its package's ``csrc/`` (the round
megakernels and the gossip stage on thread-block clusters and the wire
stages under
``src/repro_torch/kernels/gossip``, decode attention and flash attention
under ``kernels/decode_attention`` and ``kernels/flash_attention``, WKV-6
and the RG-LRU scan under ``kernels/rwkv6_scan`` and
``kernels/rglru_scan``; one ``nvcc`` per source, all started together,
into each package's ``build/``), holds each against its plain PyTorch
twin on the card (dense and top-k wires, the round kernels also on exact
ties at the top-k threshold, and every DP wrapper against its twin on
the substituted residual; the gossip kernels also at the backbone
scope's (20, 1408) wire at chunk 128; attention at the tests' shapes,
SmolLM-360M's and RecurrentGemma-2B's head size 256, a 4,096-token
prefill, a 32,768-slot cache split over blocks and merged by the combine
kernel, bf16 and fp32; the scans at the reference suite's shapes, S = 1,
either side of WKV-6's 16-step chunk, strong decay, S 4096, ragged RG-LRU
widths and lengths and the serving paths' shapes, RG-LRU bitwise), drives the port's paths -- the paper's FD-DSGT on the
fused engine, FD-DSGD, FD-DSGT under bounded staleness k = 2, FD-DSGD at
k = 4, the pipelined FD-DSGT round, the top-64 wire, the paper's Fig. 2
(DSGD, DSGT, FD-DSGD and FD-DSGT at Q = 100 on the exact-wire tree
engine, 3000 iterations each, against the same run on the CPU, which
runs on the host while the kernels build), the compressed FD-DSGT composition (the flat engine, then
``make_compressed_flat_gossip`` on each wire, against the fused engine),
the sharded engine on a one-rank NCCL group (FD-DSGD and FD-DSGT,
sequential and pipelined, on the compact top-16 and top-64 wires and the
dense int8 wire, against the fused engine on the card), the dynamic
rounds (the fused engine under topology and node programs -- node churn,
edge failure, stragglers at k = 2 and 4, payload drop, RGG rewiring,
round-robin subgraphs -- each round's realized W_off bitwise the CPU's,
then the three EHR round-axis drivers in full, their realized fractions
against the committed experiments/*_ehr.json), the sharded engine under
the programs ((h): node churn, edge failure, stragglers at k = 2 and
``slow_uplink``'s per-node wire k, against the fused engine on the card
or, for ``slow_uplink``, the same run on the CPU), the privacy axis ((i)
dp on the fused engine against the CPU, ``secure_agg`` bitwise the
unmasked run; (j) the privacy driver in full against
experiments/privacy_ehr.json; (k) dp on the sharded dense wire against
the fused engine), the federation scope ((s1) the personalization
driver uncut, its three cells against the same driver on the CPU and the
bytes of experiments/personalization_ehr.json; (s2) the backbone scope on
fused FD-DSGD / FD-DSGT, sequential, pipelined, k = 2 and dp: the private
columns bitwise their inits under a zero gradient, the losses against
the CPU; (s3) ``layerwise:freq=4``; (s4) ``sharded_fused`` under the
backbone scope), checkpoints (a scoped k = 2 run saved, restored and
resumed bitwise the uninterrupted run; a fused checkpoint onto the
sharded engine; a mismatched scope refused), snapshots (the backbone
run's per-hospital heads; SmolLM-360M served from its 1.45 GB snapshot,
hot-swapped by ``publish_snapshot``) and serving: SmolLM-360M
at full width with random weights,
``ServeEngine.generate`` (batch 8, 128 prompt + 64 new tokens, greedy,
a second weight set published mid-run), the bundle's prefill against
the decode replay, and the first 16 steps teacher-forced on the host CPU;
then RWKV6-7B and RecurrentGemma-2B at full width and depth, one after
the other (``generate`` at batch 8, 128 prompt + 32 new tokens, then
``prefill_fn`` against the decode replay, then a reduced-depth copy
against the host CPU) -- counting each kernel's launches per path, and
times the kernels, their twins, the library attention call and whole
rounds (the backbone-scoped round beside the full one at chunk 128) and
decode steps of the three served models, beside an empty
kernel's launch (the launch floor). Phase 5 then trains the
transformer: (t1) each kernel's autograd.Function (the hand kernel
forward, the plain closed-form backward) against autograd through its
twin on the card at the training shapes, and full-width SmolLM-360M (2
layers, fp32 and bf16), RecurrentGemma-2B (one period) and RWKV6-7B (one
layer) at fp32, 2 nodes: every leaf's gradient on the card against the
host CPU's, none zero (the host CPU's halves of (t1), (z2) and (z3) run
in a process of their own beside phases 2 and 3, from the same seeded
weights, drawn by the card's generator a leaf at a time; the process
runs the card halves too, when the card's process asks); (t2) SmolLM-360M at full width and depth through
``train_decentralized``, one FD-DSGT round on the tree engine (4 nodes)
and on the fused engine (2 nodes), round 1's local loss against the host
CPU's, the host clock, busy share and peak memory, and
``fused_round_gt`` at (2, 361,821,184) against its twin on its first
and last chunks and its byte bound; (t3) ``examples/serve_consensus.py``
at full width, the served tokens equal to an in-memory engine's; (t4)
``launch/train.py`` at its defaults and on the fused engine at
staleness depth 2, and ``examples/quickstart.py``, each loss falling.
Phase 6 runs the rest of the model zoo at published widths: (z1)
phi3-medium-14b, qwen2.5-32b, the MoE dbrx-132b and llama4-scout, the
InternVL2-26B backbone (with its 1,024 prefix embeddings) at the depths
one card holds, and whisper-medium whole (1,500 frames), each served by
``generate`` and ``prefill_fn`` with its launches held, its decode step
profiled; (z2) one arch per family against the host CPU at fp32 (tokens
equal) and bf16, MoE routing compared choice by choice; (z3) one fp32
gradient evaluation of llama4-scout (aux loss included) and whisper
against the host CPU; (z4) the attention kernels at the zoo's shapes
(head size 128 at GQA groups 4-6, whisper's non-causal encoder, its
cross-attention and its 1,500-slot cross cache) timed against their
twins, bounds and ``scaled_dot_product_attention``, after phase 2 held
them to their twins.
Phase 4's kernel rows come from ``repro_torch.benchmarks.kernel_bench``,
which holds the byte and operation counts of every bound.
Phase 7 runs bf16 flat storage and the standalone drivers: (b1) the
paper's configuration on the fused engine with bf16 params, tracker and
previous gradient (FD-DSGT sequential, k = 2 and top-64, FD-DSGD), the
buffers still bf16, the wire bytes fp32's, against the same runs on the
CPU twins and the fp32 runs on the card; (b2) the sharded engine with
bf16 storage on a one-rank NCCL group against the fused engine (the
dense wire within one bf16 ulp after a round); (b3) SmolLM-360M from a
bf16 snapshot (half the bytes), served with a hot swap, its prefill
logits against the fp32 snapshot's; (b4) ``launch/train.py --no-smoke
--fl-engine fused`` on SmolLM-360M, fp32 then bf16 storage, the final
state's dtypes and the peak memory by stage side by side; (d)
``benchmarks/run.py --fast`` (Theorem 1, the byte table, the ablations)
against the same drivers on the host CPU; then the bf16 round (profiled
in phase 4) and comm step beside fp32's.
Phase 8 runs the circulant torus wire and the two-axis layout on a
one-rank NCCL group (every torus edge a local copy; the transport
across ranks and S > 1 are the CPU tests' gloo ranks): (c1) the paper's
configuration on ``sharded_fused`` with ``w=None`` over the {pod 4, data
5} torus -- FD-DSGT sequential, pipelined, top-64, ``node_churn``,
``secure_agg`` (bitwise the plaintext run), ``backbone`` at chunk 128,
``axes_subset=("data",)``, and FD-DSGD -- one wire-stage launch a
round, the exact wire bytes, against ``FusedEngine`` on the torus's
dense equivalent and the same runs on the host CPU's twins; (c3) the
torus round profiled beside the all-gather round at the same
configuration; (c2) ``examples/train_100m.py --fl-engine sharded_fused
--arch smollm-360m --nodes 2 --model-shards 1`` at full width and depth,
one round, its launches, host clock, busy share and peak memory, the
losses against ``--fl-engine fused`` on the same W.
The round kernels' two-pass route (the wire stage, then the mix kernel
``csrc/round_mix.cu``), which serves the federations the one-pass
cluster kernel cannot hold in a block's shared memory: phase 2 holds it
against the twins at 192 nodes (every flag combination, dense and
top-64), DSGT top-64 at 128, the complete graph at 512, 1,024 nodes on
an Erdos-Renyi graph at 1 GB a buffer and 2,101 under the stale mix,
and every earlier shape to its one-pass launch; the mix alone against
its twin on a ring, the complete graph and random graphs up to 16,000
nodes (its band path), aligned and not; and the route (wire stage, then
mix) equal to the one-pass kernel bitwise where both run ((20, 1536),
a 128-node ring at 65,536 columns); phase 3 runs (L1) FD-DSGT, FD-DSGD
and the gossip stage at 256 hospitals on a ring (two launches a round)
against the host CPU and (L2) the ``error_feedback`` /
``difference_coding`` knobs on ``fused`` and ``sharded_fused`` (both
wires); phase 4 times the route at 1,024 nodes beside its bound and
``torch.sparse.mm``, and the mix alone on a 1,024-node ring and the
512-node complete graph.
Phase 9 runs the dry run on the host ((r1) the reference's two
committed records, (r2) the prediction for phase 8's (c2) round held
against it), its processes beside tensor parallelism on the card
(ROADMAP.md item 18b slices (i) and (ii)): a model group of two
processes that share the card over gloo (``python -m
repro_torch.benchmarks.tensor_parallel --backend gloo``), SmolLM-360M at
full width and depth: (p1) one
``lm_loss`` forward and backward at batch 8, S 128, bf16 compute on the
two ranks' shards (15 heads and 5 kv heads over 2 ranks: both cut
through a head) against the whole model on the card, the loss and the
gradients reassembled from the shards, the replicated leaves' gradients
bitwise equal on both ranks, the model group's collectives counted
against the layers, each rank's flash launches; (p2) one FD-DSGT
``tree`` round at Q = 1 on 2 nodes x 2 shards against the whole-model
``tree`` round; then (p3) llama4-scout-17b-a16e at full width, one
layer (16 experts, 8 a
rank, the shared expert split, the router and the norms replicated), its
``lm_loss`` as (p1), the routing compared between the ranks and with
the whole model's; (p4) InternVL2-26B at full width, one layer, with its
1,024 prefix embeddings, its ``lm_loss`` as (p1); then the recurrent and
audio families at full width (ROADMAP.md item 18b slice (iii)): (p5)
rwkv6-7b at 2 layers and fp32 compute (the WKV-6 kernel on each rank's
32 of 64 heads; the loss within 1e-5, the gradients within 1e-2 of their
scale, printed beside the whole model's own one-ulp response), (p6) recurrentgemma-2b at one period (recurrent, recurrent,
local_attention: the RG-LRU scan on each rank's 1,280 of 2,560 channels,
the paired ``in_proj`` cut, flash on its 5 heads), (p7) whisper-medium at
2 encoder and 2 decoder layers over 1,500 frames (flash on each rank's 8
heads in the encoder, the decoder's self- and cross-attention), each
``lm_loss`` / ``encdec_loss`` as (p1), each kernel's launches a rank
counted exactly. (p3)-(p7) run the loss alone (the ``tree`` rounds of
(p3) / (p4) do not fit one card); the CPU tests and the dry run hold
their rounds.
Any failed check raises, so the exit code is non-zero; without a
CUDA card (or without the repository around it) the script fails before
printing any result.

Output: progress lines, then the card's name and power limit as
``nvidia-smi`` reports them, a ``{"kernels": [...]}`` JSON line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import queue
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.benchmarks import (  # noqa: E402
    churn_ehr,
    personalization_ehr,
    privacy_ehr,
    staleness_ehr,
    straggler_ehr,
)
from repro_torch.benchmarks.fig2_comm_rounds import ALGOS, claims  # noqa: E402
from repro_torch.benchmarks.tensor_parallel import RouteLog  # noqa: E402
from repro_torch.benchmarks.fig2_comm_rounds import run as fig2_run  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import FLRunConfig  # noqa: E402
from repro_torch.configs.ehr_mlp import class_weights  # noqa: E402
from repro_torch.core.compression import (  # noqa: E402
    init_flat_compression_state,
    make_compressed_flat_gossip,
)
from repro_torch.core.dynamics import _as_key, parse_program  # noqa: E402
from repro_torch.core import engine as engine_module  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    FlatEngine,
    FusedEngine,
    ShardedFusedEngine,
    get_engine,
)
from repro_torch.core.fl import (  # noqa: E402
    FLConfig,
    init_fl_state,
    make_fl_round,
    tree_map,
    value_and_grad,
)
from repro_torch.core.privacy import analytic_epsilon  # noqa: E402
from repro_torch.core.packing import flat_wire_bytes, pack, tree_leaves, unpack  # noqa: E402
from repro_torch.core.schedules import inv_sqrt  # noqa: E402
from repro_torch.core.topology import check_assumption1, mixing_matrix  # noqa: E402
from repro_torch.data.ehr import generate_ehr_cohort, make_node_batcher  # noqa: E402
from repro_torch.data.tokens import make_fl_token_batches  # noqa: E402
from repro_torch.examples import quickstart, serve_consensus  # noqa: E402
from repro_torch.examples.ehr_federated import (  # noqa: E402
    run_fused_engine,
    run_sharded_engine,
)
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.op_analysis import op_analysis  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    combine_partials,
    decode_attention,
    split_plan,
)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    combine_partials_ref,
    decode_attention_ref,
)
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.gossip import ops as gossip_wrappers  # noqa: E402
from repro_torch.kernels.gossip.ops import (  # noqa: E402
    GOSSIP_STAGE,
    ONE_PASS,
    TWO_PASS,
    fused_round,
    fused_round_gt,
    gossip_mix,
    round_mix,
    wire_stage,
    wire_stage_compact,
    wire_stage_gossip,
    wire_stage_gt,
    wire_stage_gt_compact,
)
from repro_torch.kernels.rglru_scan.ops import rglru_scan  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import wkv6  # noqa: E402
from repro_torch.kernels.gossip.ref import (  # noqa: E402
    fused_round_gt_ref,
    fused_round_ref,
    gossip_mix_ref,
    round_mix_ref,
    wire_stage_gossip_ref,
)
from repro_torch.benchmarks import ablations, thm1_speedup  # noqa: E402
from repro_torch.benchmarks import kernel_bench as kb  # noqa: E402
from repro_torch.benchmarks import run as run_all  # noqa: E402
from repro_torch.benchmarks.kernel_bench import (  # noqa: E402
    ALL_KERNELS,
    ALPHA,
    ATTENTION_KERNELS,
    COMPACT_KERNELS,
    HBM_BYTES_S,
    KERNELS,
    LARGE,
    MAIN,
    SCAN_KERNELS,
    TOPK_MAIN,
    WIRE_KERNELS,
    bound,
    combine_inputs,
    device_ms,
    fused_plan,
    lru_inputs,
    make_inputs,
    mix_terms,
    round_bytes,
    round_ops,
    weights,
    wkv_inputs,
    wkv_twin,
)
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.mesh import NodeGroup, start_group, stop_group  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec as encdec_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.mlp import (  # noqa: E402
    make_mlp_loss,
    mlp_balanced_accuracy,
    mlp_init,
)
from repro_torch.models.transformer import lm_loss  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.training.checkpoint import load_fl_state, save_fl_state  # noqa: E402
from repro_torch.training.snapshot import load_snapshot, write_snapshot  # noqa: E402
from repro_torch.training.trainer import (  # noqa: E402
    stack_batches,
    stack_for_nodes,
    train_decentralized,
)

# The redesigned kernels' times in their earlier designs, us, CUDA events,
# median of 60, on an H100 80GB HBM3 at 700 W, printed in brackets beside
# the present times: the round kernels and the gossip stage on one
# 512-thread block a scale chunk (the wires in series, a 31-step threshold
# search), the DSGT compact wire stage on one warp a (row, chunk) (the
# wires in series, the 31-step search, a one-lane rank count)
EARLIER_US = {
    ("fused_round", "main"): 22.05, ("fused_round", "large"): 1862.69,
    ("fused_round", "main top-64"): 55.34,
    ("fused_round_gt", "main"): 39.87, ("fused_round_gt", "large"): 3596.13,
    ("fused_round_gt", "main top-64"): 106.34,
    ("gossip_mix", "main"): 20.03, ("gossip_mix", "large"): 1659.07,
    ("gossip_mix", "main top-64"): 54.06,
    ("wire_stage_gt_compact", "main"): 40.02, ("wire_stage_gt_compact", "large"): 2150.38,
    ("wire_stage_gt_compact", "main top-16"): 37.34,
}
WRAPPERS = [gossip_mix, fused_round, fused_round_gt, wire_stage, wire_stage_gt,
            wire_stage_compact, wire_stage_gt_compact, decode_attention, flash_attention,
            wkv6, rglru_scan, round_mix, wire_stage_gossip]
# the round wrappers, whose two-pass route counts its wire stage under
# the wire stage's own name (``kb.ROUTE_WIRES``: wire_stage_gossip,
# wire_stage, wire_stage_gt) and its mix under ``round_mix``: name ->
# (wrapper, twin, wires)
ROUND_WRAPPERS = {"gossip_mix": (gossip_mix, gossip_mix_ref, GOSSIP_STAGE),
                  "fused_round": (fused_round, fused_round_ref, 1),
                  "fused_round_gt": (fused_round_gt, fused_round_gt_ref, 2)}
# (label, nodes, flat width, scale chunk, topology): the main path, a
# ragged shape with one all-zero row chunk (exercises safe = 1), a large
# shape that makes the kernel bandwidth-bound, and the backbone scope's
# wire at chunk 128 (1,376 shared columns of the MLP's 1,536, padded to 11
# chunks: the personalization driver's geometry)
SHAPES = [MAIN, ("zero-chunk", 7, 384, 128, "complete"), LARGE,
          ("scope", 20, 1408, 128, "hospital20")]
FLAGS = list(itertools.product([True, False], repeat=3))  # ef, dc, stale
# The two-pass route (phase 2): (label, nodes, flat width, scale chunk,
# topology, topks, flag combinations) -- the first federation past the
# one-pass plan over the whole FLAGS sweep, dense and top-64; DSGT at
# top-64 at 128 nodes, the first shape the plan refuses; a dense W_off;
# 1,024 nodes on an Erdos-Renyi graph of about ten neighbours a node (1 GB
# a buffer), at two flag combinations; 2,101 nodes (the mix's narrower
# strips) under the stale mix
TWO_PASS_SHAPES = [
    ("federation-192", 192, 65_536, 512, "ring", (None, TOPK_MAIN), FLAGS),
    ("dsgt-128-top64", 128, 65_536, 512, "ring", (TOPK_MAIN,), FLAGS),
    ("complete-512", 512, 4_096, 512, "complete", (None,), FLAGS),
    (*kb.FEDERATION, (None,), [(True, True, False), (False, False, True)]),
    ("federation-2101", 2101, 1024, 512, "erdos_renyi", (None,),
     [(True, True, True), (False, False, True)]),
]
# The mix kernel alone (phase 2): (nodes, flat width, offset of the
# buffers from 16-byte alignment, graph) -- a ring, the complete graph, a
# random W with exact zeros (the strip path; 2,101 nodes its narrower
# strips; 16,000 the band path's j windows), the 4-byte copies (t not a
# multiple of 4, a buffer one float off alignment), a ragged last strip
MIX_SHAPES = [(1024, 4096, 0, "ring"), (512, 4096, 0, "complete"), (1024, 4096, 0, "random"),
              (2101, 64, 0, "random"), (16000, 64, 0, "random"), (16000, 67, 1, "random"),
              (300, 1027, 1, "random"), (7, 1030, 0, "random"), (5, 3, 0, "random")]
# The route's mix against the one-pass kernel's, bitwise, where both run:
# (label, nodes, flat width, topology) at chunk 512
ONE_PASS_MIX_SHAPES = [("hospital20", 20, 1536, "hospital20"), ("ring-128", 128, 65_536, "ring")]
# (L1) the MLP at a federation the one-pass plan refuses: hospitals on a
# ring, rounds at Q = 10; the multi-round tolerances against the host CPU
LARGE_HOSPITALS, LARGE_ROUNDS, LOSS_RTOL, BAL_ACC_TOL = 256, 5, 1e-3, 0.02
# (L2) item 9: (error_feedback, difference_coding) with a knob off
KNOB_RUNS = [(False, True), (True, False), (False, False)]
EF_DC = list(itertools.product([True, False], repeat=2))
# DSGT wire bytes per round on hospital20 (2 wires x 54 directed edges x
# (1536 int8 + 3 fp32 scales)); DSGD ships one wire; the top-64 wire
# ships 132 B per chunk (64 values, a 64 B presence bitmap, the scale)
WIRE_DSGT, WIRE_DSGD, WIRE_TOP64 = 167_184, 83_592, 42_768
# The sharded engine's wires on the paper's buffer at chunk 512: top-16
# ships int16 positions (32 B < a 64 B bitmap), top-64 the bitmap (64 B <
# 128 B); per-round bytes (all nodes) by (topk, algorithm)
SHARDED_TOPKS = (16, 64)
SHARDED_WIRE = {(64, "dsgt"): 42_768, (64, "dsgd"): 21_384, (16, "dsgt"): 16_848,
                (16, "dsgd"): 8_424, (None, "dsgt"): 167_184, (None, "dsgd"): 83_592}
SHARDED_ROUNDS = 5
FIG2_ITERATIONS = 3000  # the paper's budget per algorithm
# final Fig. 2 losses, card against CPU: the exact wire has no int8 step
# to flip, so the runs differ only by fp32 summation order (the port's
# CPU run and the reference's agree within 5e-7 relative over 3000
# iterations). The CPU run needs no kernel: it runs while they build.
FIG2_RTOL = 1e-4

# The serving path: SmolLM-360M at full width (32 layers, d_model 960, 15
# q-heads over 5 kv-heads, vocab 49,152), random weights from seeded CUDA
# generators; batch 8, caches of 4096 slots, 128 prompt and 64 new tokens
# (191 decode steps), a second weight set published after step 150.
SERVE_ARCH, SERVE_BATCH, SERVE_MAX_SEQ = "smollm-360m", 8, 4096
SERVE_PROMPT, SERVE_NEW, SWAP_AFTER, CPU_STEPS = 128, 64, 150, 16
# phase 4's decode-step profiles of the three served models fill the cache
# with the prompt's first PROFILE_PROMPT tokens, one decode step each (the
# host-bound step's time hardly depends on the cache's length)
PROFILE_PROMPT = 32
# bf16 logits of two computations of one model (decode replay vs prefill,
# card vs host CPU): 5e-2 x max(1, max|logit|), the reference suite's own
# tolerance for decode vs prefill (tests/test_serving.py)
SERVE_LOGIT_TOL = 5e-2

# The recurrent serving paths, at full width and depth with random weights
# from seeded CUDA generators: RWKV6-7B (32 rwkv layers, d_model 4096, 64
# WKV heads, vocab 65,536) and RecurrentGemma-2B (26 layers: 18 RG-LRU, 8
# local attention with head size 256 and a 2048-slot ring). Each: batch 8,
# 128 prompt + 32 new tokens, greedy (159 decode steps) on max_seq 4096;
# then prefill_fn on the prompt; then the card against the host CPU over
# a few teacher-forced steps at reduced depth (n_layers), full width.
RECURRENT_ARCHS = {"rwkv6-7b": 2, "recurrentgemma-2b": 3}
REC_NEW, REC_CPU_STEPS = 32, 6
# bf16 prefill vs the decode replay, max diff over max(1, max|logit|).
# RecurrentGemma: SERVE_LOGIT_TOL. RWKV6: 1e-1 -- the reference's
# prefill runs the token shift in fp32 (its zero fp32 carries promote the
# whole sequence) and its decode in bf16 from the second step on, so the
# two paths round differently at every layer; over 32 layers that alone
# moves the last logits by 4.0e-2 of their scale in the reference and
# 3.8e-2 in the port on the same weights (tests/test_torch_transformer.py
# ::test_rwkv_prefill_replay_gap_is_the_references), more on other draws.
REC_PREFILL_TOL = {"rwkv6-7b": 1e-1, "recurrentgemma-2b": SERVE_LOGIT_TOL}
# At reduced depth and full width, fp32 compute: prefill vs the card's
# replay within 1e-2 (the replay's KV cache rounds K/V to bf16, prefill
# does not: the port's test_decode_replay_matches_prefill tolerance), the
# card's replay vs the host CPU's within 1e-3 (one fp32 function summed
# in another order). Both run at fp32 and shallow because RWKV6's first
# decode step is ill-conditioned: a head's WKV output is rank one there
# and its RMS norm divides by the bonus r . (u * k), so where that is
# near 0 a rounding difference moves the head's output by up to its own
# size, and the slow decay (w ~ 0.9975 a step) carries it on; through 32
# layers that swamps any tolerance a kernel could be held to.
REC_FP32_PREFILL_TOL, REC_FP32_CPU_TOL = 1e-2, 1e-3
# WKV-6 and RG-LRU kernels vs their twins: the reference suite's own
# tolerances for these functions (tests/test_kernels.py), as |got - want|
# <= atol + rtol |want|
SCAN_TOL = {"wkv6": (5e-4, 1e-3), "rglru_scan": (1e-4, 1e-4)}

# The dynamic rounds: the paper's configuration on the fused engine with
# each round's realized W (topology program, node program) handed to the
# round kernels -- (label, algorithm, schedule, topology program, node
# program, rounds, the kernel each round launches once)
DYNAMIC_RUNS = [
    ("(a) FD-DSGT node churn", "dsgt", "sequential",
     "node_churn:p_down=0.25,mean_downtime=5", None, 20, "fused_round_gt"),
    ("(b) FD-DSGD edge failure", "dsgd", "sequential", "edge_failure:p=0.4375", None, 5,
     "fused_round"),
    ("(c) FD-DSGT k=2 stragglers", "dsgt", "bounded_staleness:k=2", None,
     "stragglers:frac=0.5,rate=0.5,drop=1", 20, "wire_stage_gt"),
    ("(d) FD-DSGT pipelined payload drop", "dsgt", "pipelined", None,
     "payload_drop:p=0.1", 5, "fused_round_gt"),
    ("(e) FD-DSGT rgg rewire", "dsgt", "sequential", "rgg_rewire", None, 5,
     "fused_round_gt"),
    ("(f) FD-DSGT round-robin subgraphs", "dsgt", "sequential", "round_robin_subgraphs",
     None, 5, "fused_round_gt"),
    ("(g) FD-DSGD k=4 stragglers", "dsgd", "bounded_staleness:k=4", None,
     "stragglers:frac=0.5,rate=0.5,drop=1", 5, "wire_stage"),
]
# (h) the sharded engine under the programs, 5 rounds each on the
# one-rank NCCL group -- (label, algorithm, schedule, topk, axes)
SHARDED_DYNAMIC_RUNS = [
    ("(h1) sharded FD-DSGT node churn int8", "dsgt", "sequential", None,
     dict(topology_program=DYNAMIC_RUNS[0][3])),
    ("(h2) sharded FD-DSGD edge failure top-64", "dsgd", "pipelined", 64,
     dict(topology_program=DYNAMIC_RUNS[1][3])),
    ("(h3) sharded FD-DSGT k=2 stragglers top-16", "dsgt", "bounded_staleness:k=2", 16,
     dict(node_program=DYNAMIC_RUNS[2][4])),
    ("(h4) sharded FD-DSGT slow uplink top-64", "dsgt", "sequential", 64,
     dict(node_program="slow_uplink:frac=0.25,k_scale=0.25")),
]
# (i)-(k) the privacy axis
DP_SPEC = "dp:sigma=0.5,clip=1.0"
# (s1)-(s4) the federation scope, at the personalization driver's chunk
# and alpha on its hardened cohort: the backbone wire's bytes a round
# (hospital20's 54 directed edges, 11 chunks of 128) by algorithm and
# topk -- dense 1,408 + 44 B an edge and wire, top-16 36 B a chunk (16
# values, a 16 B bitmap, the scale); the driver's three cells' bytes
SCOPE_CHUNK, SCOPE_ROUNDS = 128, 5
SCOPE_WIRE = {(None, "dsgt"): 156_816, (None, "dsgd"): 78_408, (16, "dsgt"): 42_768,
              (16, "dsgd"): 21_384}
PERSONALIZATION_WIRE = {"full": 171_072, "backbone": 156_816, "layerwise_freq4": 171_072}
PERSONALIZATION_ROUNDS = 150
# (s2)'s schedules and privacy specs, each on fused FD-DSGD and FD-DSGT
SCOPE_RUNS = (("sequential", None), ("pipelined", None), ("bounded_staleness:k=2", None),
              ("sequential", DP_SPEC))
# a scoped run on the card against the same run on the CPU twins, the
# per-round losses (relative)
SCOPE_LOSS_RTOL = 1e-5
# the driver on the card against the driver on the CPU from the same init:
# each cell's mean per-hospital balanced accuracy
PERSONALIZATION_BAL_TOL = 0.02
# serving SmolLM-360M from its snapshot: batch 8, 16 prompt + 32 new
# tokens, a second snapshot published after decode step 24
SNAPSHOT_PROMPT, SNAPSHOT_NEW, SNAPSHOT_SWAP_AT = 16, 32, 24
# the EHR drivers' full runs: 6 + 5 + 13 cells; their realized fractions
# (a function of the programs alone) against the committed JSONs within
# this, their bal_acc printed beside the JSONs' (another init: the JSONs'
# came from jax.random, the port's from a torch.Generator)
DRIVER_FRACTION_TOL = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


_START = time.perf_counter()


def section(msg: str) -> None:
    """A phase's or path's heading, with the seconds since the script
    started (the run must end inside its time limit, the build included)."""
    log(f"{msg} [{time.perf_counter() - _START:.1f} s]")


_PHASES: list = []


def phase(title) -> None:
    """A phase's heading (:func:`section`), after the previous phase's
    seconds; ``phase(None)`` closes the last one and prints every
    phase's seconds."""
    now = time.perf_counter()
    if _PHASES:
        _PHASES[-1][2] = now - _PHASES[-1][1]
        log(f"  ({_PHASES[-1][0]}: {_PHASES[-1][2]:.1f} s)")
    if title is None:
        log("phase seconds: " + json.dumps({p[0]: round(p[2], 1) for p in _PHASES}))
        return
    _PHASES.append([title.split(":")[0], now, None])
    section(title)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def shape_topks(chunk: int):
    """The round kernels' top-k cases: dense, the reference example's 64
    at chunk 512, and k = chunk/8 at a smaller chunk."""
    return [None, TOPK_MAIN if chunk == 512 else chunk // 8]


def check_kernels() -> dict:
    """Every round kernel against its twin on the card, at every shape,
    flag combination and top-k case, and at the main shape on exact ties
    at the top-k threshold (k = chunk/4, every tie kept on each wire):
    recon', res' and scales bitwise, mixed within 1e-5 x max(1,
    max|input|) (the n x n sum runs in another order)."""
    max_err = {name: 0.0 for name in KERNELS}
    tie_case = [(SHAPES[0], "ties")]
    for (name, (kernel, twin, wires, _, _)), ((label, n, t, chunk, topo), case) in (
            itertools.product(KERNELS.items(), [(s, None) for s in SHAPES] + tie_case)):
        w_off, w_self = weights(topo, n)
        ties = case == "ties"
        topks = [chunk // 4] if ties else shape_topks(chunk)
        for k, ((ef, dc, stale), topk) in enumerate(itertools.product(FLAGS, topks)):
            bufs = make_inputs(n, t, chunk, wires, label, seed=k, ties=ties)
            kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                      stale_mix=stale, topk=topk)
            got = kernel(*bufs, w_off, w_self, ALPHA, **kw)
            want = twin(*bufs, w_off, w_self, ALPHA, **kw)
            torch.cuda.synchronize()
            n_mixed = wires
            for i, (a, b) in enumerate(zip(got, want)):
                if not torch.isfinite(a).all() or a.shape != b.shape:
                    raise AssertionError(f"{name} {label} {kw}: output {i} bad")
                if i < n_mixed:
                    err = float((a - b).abs().max())
                    tol = 1e-5 * max(1.0, max(float(x.abs().max()) for x in bufs))
                    if err > tol:
                        raise AssertionError(
                            f"{name} {label} {kw}: mixed off by {err} > {tol}")
                    max_err[name] = max(max_err[name], err)
                elif not torch.equal(a, b):
                    raise AssertionError(
                        f"{name} {label} {kw}: output {i} differs from the twin "
                        f"(max {float((a - b).abs().max())})")
            if label == "zero-chunk":
                for sc in got[-wires:]:
                    if float(sc[3, 1]) != 0.0:
                        raise AssertionError(
                            f"{name}: all-zero chunk got scale {float(sc[3, 1])}")
            if ties:
                # recon' on (row 0, chunk 0) is 0 + dq: nonzero exactly on
                # the kept columns, on each wire
                for i in range(wires):
                    kept = int(torch.count_nonzero(got[wires + 2 * i][0, :chunk]))
                    if kept != chunk // 8 + chunk // 4:
                        raise AssertionError(
                            f"{name} {label} {kw}: kept {kept} columns of the tie "
                            f"chunk on wire {i}, want {chunk // 8 + chunk // 4}")
            del got, want, bufs
        clusters = fused_plan(name, n, t, chunk, None)[0]
        log(f"  {name} == twin at {label} ({n}x{t}, chunk {chunk}, clusters of "
            f"{clusters}): 8 flag combinations x topk {topks}"
            f"{' (exact ties, all kept)' if ties else ''}, recon/res/scales "
            f"bitwise, mixed max err {max_err[name]:.3e}")
        torch.cuda.empty_cache()
    return max_err


def check_wire_stages() -> dict:
    """Both wire-stage kernels against their twins on the card, at every
    shape, for the 4 (ef, dc) combinations x topk in {None, chunk/4 with
    exact ties at the threshold, chunk}: every output (h, t_half, q,
    scales, recon', res') bitwise; the tie case keeps every tie."""
    max_err = {name: 0.0 for name in WIRE_KERNELS}
    for (name, (kernel, twin, wires, _, _)), (label, n, t, chunk, _) in itertools.product(
            WIRE_KERNELS.items(), SHAPES):
        topks = [None, chunk // 4, chunk]
        for k, ((ef, dc), topk) in enumerate(itertools.product(EF_DC, topks)):
            ties = topk == chunk // 4
            bufs = make_inputs(n, t, chunk, wires, label, seed=k, ties=ties)
            kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                      topk=topk)
            got = kernel(*bufs, ALPHA, **kw)
            want = twin(*bufs, ALPHA, **kw)
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(got, want)):
                if a.shape != b.shape or a.dtype != b.dtype or not torch.isfinite(a.float()).all():
                    raise AssertionError(f"{name} {label} {kw}: output {i} bad")
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"{name} {label} {kw}: output {i} differs from the twin "
                        f"(max {float((a.float() - b.float()).abs().max())})")
            if ties:
                for i in ([1] if wires == 1 else [2, 6]):
                    kept = int(torch.count_nonzero(got[i][0, :chunk]))
                    if kept != chunk // 8 + chunk // 4:
                        raise AssertionError(
                            f"{name} {label} {kw}: kept {kept} columns of the tie "
                            f"chunk, want {chunk // 8 + chunk // 4}")
            if label == "zero-chunk":
                sc = got[2 if wires == 1 else 3]
                if float(sc[3, 1]) != 0.0:
                    raise AssertionError(f"{name}: all-zero chunk got scale {float(sc[3, 1])}")
            del got, want, bufs
        log(f"  {name} == twin at {label} ({n}x{t}, chunk {chunk}): 4 (ef, dc) x "
            f"topk {topks} (ties at k={chunk // 4} all kept), every output bitwise")
        torch.cuda.empty_cache()
    return max_err


def check_compact_stages() -> dict:
    """Both compact wire-stage kernels against their twins on the card, at
    the main (20, 1536) and the large (64, 1,048,576) shape, chunk 512,
    and the backbone scope's (20, 1408) wire at chunk 128, k in {16, 64},
    explicit positions and the bitmap: every output (h,
    t_half, q, positions or bitmap, scales, recon', res') bitwise. At the
    main shape for the 4 (ef, dc) combinations, with exact ties in (row 0,
    chunk 0): magnitudes 3, 2 and 1 of both signs, 64 threes, so top-16
    keeps the 16 lowest-index threes; plus int32 positions at a 32,776-
    column chunk."""
    max_err = {name: 0.0 for name in COMPACT_KERNELS}
    cases = [(SHAPES[0], EF_DC, True), (SHAPES[2], [(True, True)], False),
             (("int32 positions", 2, 2 * 32776, 32776, None), [(True, True)], False),
             (SHAPES[3], EF_DC, False)]
    for (name, (kernel, twin, wires, _, _)), (shape, flags, ties) in itertools.product(
            COMPACT_KERNELS.items(), cases):
        label, n, t, chunk, _ = shape
        encodings = [False] if chunk % 8 else [False, True]
        for k, ((ef, dc), topk, bitmap) in enumerate(
                itertools.product(flags, SHARDED_TOPKS, encodings)):
            bufs = make_inputs(n, t, chunk, wires, label, seed=k, ties=ties)
            kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                      topk=topk, bitmap=bitmap)
            got = kernel(*bufs, ALPHA, **kw)
            want = twin(*bufs, ALPHA, **kw)
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(got, want)):
                if a.shape != b.shape or a.dtype != b.dtype:
                    raise AssertionError(f"{name} {label} {kw}: output {i} bad")
                err = float((a.float() - b.float()).abs().max())
                max_err[name] = max(max_err[name], err)
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"{name} {label} {kw}: output {i} differs from the twin (max {err})")
            if ties and topk == 16 and not bitmap:
                for i in ([2] if wires == 1 else [3, 8]):
                    pos = got[i][0, :topk].tolist()
                    if pos != sorted(pos) or len(set(pos)) != topk:
                        raise AssertionError(f"{name} {label} {kw}: tie positions {pos}")
            del got, want, bufs
        log(f"  {name} == twin at {label} ({n}x{t}, chunk {chunk}): {len(flags)} (ef, dc) x "
            f"topk {SHARDED_TOPKS} x {'positions and bitmap' if len(encodings) == 2 else 'positions'}"
            f"{', ties in (row 0, chunk 0)' if ties else ''}: every output bitwise, largest "
            f"difference {max_err[name]:.1e}")
        torch.cuda.empty_cache()
    return max_err


def check_gossip_mix() -> dict:
    """The gossip-stage kernel against its twin on the card, at every
    shape, for the 8 (ef, dc, stale) combinations x topk in {None, chunk/4
    with exact ties at the threshold, chunk}: recon', res' and scales
    bitwise, mixed as the round kernels' (1e-5 x max(1, max|input|)); the
    tie case keeps every tie."""
    max_err = {"gossip_mix": 0.0}
    for label, n, t, chunk, topo in SHAPES:
        w_off, w_self = weights(topo, n)
        topks = [None, chunk // 4, chunk]
        for k, ((ef, dc, stale), topk) in enumerate(itertools.product(FLAGS, topks)):
            ties = topk == chunk // 4
            bufs = make_inputs(n, t, chunk, 0, label, seed=k, ties=ties)
            kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                      stale_mix=stale, topk=topk)
            got = gossip_mix(*bufs, w_off, w_self, **kw)
            want = gossip_mix_ref(*bufs, w_off, w_self, **kw)
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(got, want)):
                if not torch.isfinite(a).all() or a.shape != b.shape:
                    raise AssertionError(f"gossip_mix {label} {kw}: output {i} bad")
                if i == 0:
                    err = float((a - b).abs().max())
                    tol = 1e-5 * max(1.0, max(float(x.abs().max()) for x in bufs))
                    if err > tol:
                        raise AssertionError(
                            f"gossip_mix {label} {kw}: mixed off by {err} > {tol}")
                    max_err["gossip_mix"] = max(max_err["gossip_mix"], err)
                elif not torch.equal(a, b):
                    raise AssertionError(
                        f"gossip_mix {label} {kw}: output {i} differs from the twin "
                        f"(max {float((a - b).abs().max())})")
            if ties:
                # recon' - recon is the dequantized payload: nonzero exactly
                # on the kept columns (or, without difference coding, recon'
                # itself)
                dq = got[1][0, :chunk] - (bufs[1][0, :chunk] if dc else 0.0)
                kept = int(torch.count_nonzero(dq))
                if kept != chunk // 8 + chunk // 4:
                    raise AssertionError(
                        f"gossip_mix {label} {kw}: kept {kept} columns of the tie "
                        f"chunk, want {chunk // 8 + chunk // 4}")
            if label == "zero-chunk" and float(got[3][3, 1]) != 0.0:
                raise AssertionError(f"gossip_mix: all-zero chunk got scale "
                                     f"{float(got[3][3, 1])}")
            del got, want, bufs
        log(f"  gossip_mix == twin at {label} ({n}x{t}, chunk {chunk}): 8 flag "
            f"combinations x topk {topks} (ties at k={chunk // 4} all kept), "
            f"recon/res/scales bitwise, mixed max err {max_err['gossip_mix']:.3e}")
        torch.cuda.empty_cache()
    return max_err


def route_counts() -> tuple:
    """(one-pass launches, wire-stage launches, mix launches) of the round
    wrappers and their routes' kernels since :func:`zero_counts`."""
    got = launch_counts()
    return (sum(got[name] for name in ROUND_WRAPPERS),
            sum(got[w.__name__] for w, _, _ in kb.ROUTE_WIRES.values()), got["round_mix"])


def check_two_pass() -> dict:
    """The round kernels' two-pass route (the wire stage, then the mix
    kernel) against the one-pass twins at the federations the one-pass
    plan refuses (``TWO_PASS_SHAPES``): recon', res' and scales bitwise,
    mixed within 1e-5 x max(1, max|input|), two launches a call and none
    of the one-pass kernel; the route each (kernel, shape) takes printed;
    then every existing shape (``SHAPES``) still one one-pass launch a
    call."""
    max_err = 0.0
    for label, n, t, chunk, topo, topks, flags in TWO_PASS_SHAPES:
        kw_w = {"p": kb.FEDERATION_P} if topo == "erdos_renyi" else {}
        if label == kb.FEDERATION[0]:  # the timed federation's graph
            w = mixing_matrix(topo, n, **kw_w)
            check_assumption1(w)
            off = w - np.diag(np.diag(w))
            log(f"  {label}: W_off density {float((off != 0).mean()):.4f} (mean degree "
                f"{float((off != 0).sum(axis=1).mean()):.2f}), Assumption 1 holds")
        w_off, w_self = weights(topo, n, **kw_w)
        routes = {}
        for name, (kernel, twin, wires) in ROUND_WRAPPERS.items():
            for topk in topks:
                route = kb.route_plan(name, n, t, chunk, topk)[0]
                routes[f"{name} top-{topk}" if topk else name] = route
                if route != TWO_PASS:
                    continue
                for k, (ef, dc, stale) in enumerate(flags):
                    bufs = make_inputs(n, t, chunk, wires, label, seed=k)
                    kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                              stale_mix=stale, topk=topk)
                    args = (*bufs, w_off, w_self) + (() if wires == GOSSIP_STAGE else (ALPHA,))
                    zero_counts()
                    got = kernel(*args, **kw)
                    torch.cuda.synchronize()
                    counts = route_counts()
                    want = twin(*args, **kw)
                    torch.cuda.synchronize()
                    if counts != (0, 1, 1):
                        raise AssertionError(f"{name} {label} {kw}: (one-pass, wire, mix) "
                                             f"launches {counts}, want (0, 1, 1)")
                    nw = max(wires, 1)
                    tol = 1e-5 * max(1.0, max(float(x.abs().max()) for x in bufs))
                    for i, (a, b) in enumerate(zip(got, want)):
                        if a.shape != b.shape or a.dtype != b.dtype or not torch.isfinite(a).all():
                            raise AssertionError(f"{name} {label} {kw}: output {i} bad")
                        if i < nw:
                            err = float((a - b).abs().max())
                            if err > tol:
                                raise AssertionError(
                                    f"{name} {label} {kw}: mixed off by {err} > {tol}")
                            max_err = max(max_err, err)
                        elif not torch.equal(a, b):
                            raise AssertionError(
                                f"{name} {label} {kw}: output {i} differs from the twin "
                                f"(max {float((a - b).abs().max())})")
                    del got, want, bufs, args
                log(f"  {name} two-pass == twin at {label} ({n}x{t}, chunk {chunk}, "
                    f"{topo}{', top-' + str(topk) if topk else ''}): {len(flags)} flag "
                    f"combination(s), recon/res/scales bitwise, mixed max err so far "
                    f"{max_err:.3e}, 2 launches a call")
                torch.cuda.empty_cache()
        log(f"  routes at {label}: " + ", ".join(f"{k} {v}" for k, v in routes.items()))
        del w_off, w_self
    # the gossip stage's wire stage alone, its int8 payload too (the route
    # skips it), as check_wire_stages holds wire_stage and wire_stage_gt
    label, n, t, chunk = TWO_PASS_SHAPES[0][:4]
    topks = [None, TOPK_MAIN, chunk]
    for k, ((ef, dc), topk) in enumerate(itertools.product(EF_DC, topks)):
        bufs = make_inputs(n, t, chunk, GOSSIP_STAGE, label, seed=k)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc, topk=topk)
        zero_counts()
        got = wire_stage_gossip(*bufs, **kw)
        want = wire_stage_gossip_ref(*bufs, **kw)
        torch.cuda.synchronize()
        if launch_counts()["wire_stage_gossip"] != 1:
            raise AssertionError(f"wire_stage_gossip {kw}: launches {launch_counts()}")
        for i, (a, b) in enumerate(zip(got, want)):
            if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"wire_stage_gossip {label} {kw}: output {i} differs "
                                     "from the twin")
        del got, want, bufs
    log(f"  wire_stage_gossip == twin at {label} ({n}x{t}, chunk {chunk}): 4 (ef, dc) x "
        f"topk {topks}, q/scales/recon/res bitwise")
    # the shapes the one-pass kernel served keep it: one launch a call
    for (label, n, t, chunk, topo), (name, (kernel, _, wires)) in itertools.product(
            SHAPES, ROUND_WRAPPERS.items()):
        for topk in shape_topks(chunk):
            if kb.route_plan(name, n, t, chunk, topk)[0] != ONE_PASS:
                raise AssertionError(f"{name} at {label} top-{topk} left the one-pass plan")
            bufs = make_inputs(n, t, chunk, wires, label, seed=0)
            w_off, w_self = weights(topo, n)
            zero_counts()
            kernel(*bufs, w_off, w_self, *(() if wires == GOSSIP_STAGE else (ALPHA,)),
                   scale_chunk=chunk, topk=topk)
            if route_counts() != (1, 0, 0):
                raise AssertionError(f"{name} at {label} top-{topk}: launches "
                                     f"{route_counts()}, want one one-pass launch")
            del bufs
    torch.cuda.empty_cache()
    log(f"  every existing shape ({', '.join(s[0] for s in SHAPES)}) x the three round "
        "kernels x their top-k cases: the one-pass plan, one launch a call")
    max_err = max(max_err, check_round_mix())
    check_route_mix_bitwise()
    return {"round_mix": max_err, "wire_stage_gossip": 0.0}


def mix_weights(n: int, graph: str):
    """W_off and w_self of :data:`MIX_SHAPES`: the ring's or the complete
    graph's, or (``random``) a random W_off with exact zeros -- 2% dense
    past 100 nodes, 70% below -- made on the card from a seed."""
    if graph != "random":
        return weights(graph, n)
    gen = torch.Generator(device="cuda").manual_seed(n)
    w = torch.rand(n, n, generator=gen, device="cuda")
    w *= torch.rand(n, n, generator=gen, device="cuda") >= (0.98 if n > 100 else 0.3)
    w.fill_diagonal_(0.0)
    return w, torch.rand(n, generator=gen, device="cuda")


def check_round_mix() -> float:
    """The mix kernel alone against its twin at :data:`MIX_SHAPES`, one
    and two wires: one launch a call, within 1e-5 x 4 x (W's largest row
    sum + 1). Returns the largest error."""
    max_err = 0.0
    for n, t, offset, graph in MIX_SHAPES:
        w_off, w_self = mix_weights(n, graph)
        scale = float(w_off.abs().sum(dim=1).max()) + 1.0
        for wires in (1, 2):
            gen = torch.Generator(device="cuda").manual_seed(t)
            bufs = [torch.randn(n * t + offset, generator=gen, device="cuda")[offset:].view(n, t)
                    for _ in range(2 * wires)]
            zero_counts()
            got = round_mix(w_off, w_self, bufs[:wires], bufs[wires:])
            torch.cuda.synchronize()
            if launch_counts()["round_mix"] != 1:
                raise AssertionError(f"round_mix ({n}, {t}): launches {launch_counts()}")
            for g, a, b in zip(got, bufs[:wires], bufs[wires:]):
                err = float((g - round_mix_ref(w_off, w_self, a, b)).abs().max())
                if not err <= 4e-5 * scale:
                    raise AssertionError(f"round_mix ({n}, {t}, offset {offset}, {graph}, "
                                         f"{wires} wire(s)): off the twin by {err}")
                max_err = max(max_err, err)
            del got, bufs
        path = "strip" if gossip_wrappers.mix_plan(n, t, 1)[1] == n else "band"
        log(f"  round_mix == twin at ({n}, {t}), offset {offset}, {graph} ({path} path): 1 "
            f"and 2 wires, max err so far {max_err:.3e}")
        del w_off, w_self
        torch.cuda.empty_cache()
    return max_err


def check_route_mix_bitwise() -> None:
    """Where the one-pass kernel runs (:data:`ONE_PASS_MIX_SHAPES`), the
    route -- the wire stage with no int8 store, then the mix kernel --
    gives the one-pass wrapper's outputs bitwise, for the gossip stage,
    DSGD and DSGT under every (ef, dc, stale): mixed by ``torch.equal``,
    recon', res' and the scales."""
    chunk = 512
    for label, n, t, topo in ONE_PASS_MIX_SHAPES:
        w_off, w_self = weights(topo, n)
        for name, (kernel, _, wires) in ROUND_WRAPPERS.items():
            if kb.route_plan(name, n, t, chunk, None)[0] != ONE_PASS:
                raise AssertionError(f"{name} at {label} left the one-pass plan")
            alpha = None if wires == GOSSIP_STAGE else ALPHA
            for k, (ef, dc, stale) in enumerate(FLAGS):
                bufs = make_inputs(n, t, chunk, wires, label, seed=k)
                kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc)
                one = kernel(*bufs, w_off, w_self, *(() if alpha is None else (alpha,)),
                             stale_mix=stale, **kw)
                olds = (bufs[4], bufs[6]) if wires == 2 else (bufs[wires + 1],)
                mixed, recons, ress, scales = gossip_wrappers._route(
                    wires, bufs, olds, w_off, w_self, alpha, stale, topk=None, **kw)
                routed = (mixed + recons + ress + scales if wires != 2 else
                          mixed + (recons[0], ress[0], recons[1], ress[1]) + scales)
                for i, (a, b) in enumerate(zip(routed, one)):
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"{name} at {label} (ef, dc, stale) {(ef, dc, stale)}: the "
                            f"route's output {i} differs from the one-pass kernel's (max "
                            f"{float((a - b).abs().max())})")
                del one, routed, mixed, bufs
        log(f"  the route (wire stage, then round_mix) == the one-pass kernel bitwise at "
            f"{label} ({n}x{t}, chunk {chunk}), the gossip stage, DSGD and DSGT x 8 flag "
            "combinations: mixed (torch.equal), recon', res', scales")
        torch.cuda.empty_cache()



# (label, B, C, H, K, hd, n_valid per row): the tests' shapes, then
# SmolLM-360M's (a row with n_valid = 0, a full row, the path's lengths),
# and a wrapped ring cache (every slot live, positions out of slot order)
DECODE_SHAPES = [
    ("test GQA 1", 3, 300, 4, 4, 64, [0, 300, 123]),
    ("test GQA 3", 3, 200, 15, 5, 64, [0, 200, 57]),
    ("test GQA 4, hd 128", 3, 130, 8, 2, 128, [0, 130, 99]),
    ("smollm", 8, 4096, 15, 5, 64, [0, 1, 64, 128, 191, 2000, 4095, 4096]),
    ("smollm wrapped ring", 8, 4096, 15, 5, 64, [4096] * 8),
]
DECODE_SHAPES += [
    # hd 256: RecurrentGemma-2B's MQA (10 q-heads over 1 kv head, three
    # blocks of at most 4 q-heads each) on its 2048-slot local ring, at the
    # tests' size, at the path's lengths, and wrapped
    ("test MQA, hd 256", 3, 150, 10, 1, 256, [0, 150, 77]),
    ("recurrentgemma", 8, 2048, 10, 1, 256, [0, 1, 64, 128, 159, 1000, 2047, 2048]),
    ("recurrentgemma wrapped ring", 8, 2048, 10, 1, 256, [2048] * 8),
    # a 32,768-slot cache: split over blocks, merged by the combine kernel;
    # an empty row, one live slot, rows about 4,096, a full row, and the
    # rows on and after the planned split boundary ("span", "span+1")
    ("split 32k", 9, 32768, 15, 5, 64,
     [0, 1, 4095, 4096, 4097, 20000, 32768, "span", "span+1"]),
]
DECODE_SHAPES += [
    # the model zoo (phase 6): head size 128 with GQA groups of 6, 5 and 4
    # (dbrx-132b / internvl2-26b, llama4-scout / qwen2.5-32b, phi3-medium)
    # on the serving paths' 4096-slot caches -- groups 5 and 6 run in a
    # q-head tile of 8 with 3 or 2 rows masked; whisper-medium's self cache
    # (448 slots, group 1) and its 1,500-slot cross cache, off the 64-slot
    # tiles, full on every row (the path) and ragged
    ("zoo hd 128, group 6", 8, 4096, 48, 8, 128, [0, 1, 63, 64, 129, 159, 4095, 4096]),
    ("zoo hd 128, group 5", 8, 4096, 40, 8, 128, [0, 1, 63, 64, 129, 159, 4095, 4096]),
    ("zoo hd 128, group 4", 8, 4096, 40, 10, 128, [0, 1, 63, 64, 129, 159, 4095, 4096]),
    ("whisper self", 8, 448, 16, 16, 64, [0, 1, 64, 159, 200, 447, 448, 100]),
    ("whisper cross", 8, 1500, 16, 16, 64, [1500] * 8),
    ("whisper cross ragged", 8, 1500, 16, 16, 64, [0, 1, 63, 64, 1471, 1472, 1499, 1500]),
]
# (label, B, Sq, Sk, H, K, hd, causal, window)
FLASH_SHAPES = [
    ("test causal, ragged", 2, 200, 200, 2, 1, 64, True, 0),
    ("test causal window, hd 128", 1, 160, 160, 4, 4, 128, True, 48),
    ("test window only", 1, 130, 130, 4, 2, 64, False, 40),
    ("smollm prefill", 8, 128, 128, 15, 5, 64, True, 0),
    ("smollm window", 8, 128, 128, 15, 5, 64, True, 64),
    # hd 256: the reference suite's windowed case, RecurrentGemma-2B's
    # prefill (window 2048) and a window that cuts into it
    ("test window, hd 256", 1, 384, 384, 8, 2, 256, True, 128),
    ("recurrentgemma prefill", 8, 128, 128, 10, 1, 256, True, 2048),
    ("recurrentgemma window 48", 8, 128, 128, 10, 1, 256, True, 48),
    # a 4,096-token prefill at SmolLM-360M's heads
    ("smollm 4096", 2, 4096, 4096, 15, 5, 64, True, 0),
    # the model zoo (phase 6): the prefills at head size 128, groups 6, 5
    # and 4; internvl2-26b's 1,024 prefix embeddings + 128 tokens;
    # whisper-medium's encoder (non-causal, 1,500 frames: neither length a
    # multiple of the 64-row tile), its decoder's cross-attention (128
    # queries over 1,500 frames) and causal self-attention
    ("zoo hd 128, group 6", 8, 128, 128, 48, 8, 128, True, 0),
    ("zoo hd 128, group 5", 8, 128, 128, 40, 8, 128, True, 0),
    ("zoo hd 128, group 4", 8, 128, 128, 40, 10, 128, True, 0),
    ("internvl2 prefix + prompt", 8, 1152, 1152, 48, 8, 128, True, 0),
    ("whisper encoder", 8, 1500, 1500, 16, 16, 64, False, 0),
    ("whisper cross", 8, 128, 1500, 16, 16, 64, False, 0),
    ("whisper cross ragged", 3, 77, 1499, 16, 16, 64, False, 0),
    ("whisper self", 8, 128, 128, 16, 16, 64, True, 0),
]


def check_attention_kernels() -> dict:
    """Both attention kernels against their twins on the card, bf16 and
    fp32, at the tests' shapes and SmolLM-360M's."""
    max_err = {"decode_attention": 0.0, "flash_attention": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, c, h, kv, hd, nv in DECODE_SHAPES:
            q = torch.randn(b, 1, h, hd, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(b, c, kv, hd, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            splits, span = split_plan(q, k)
            nv = [{"span": span, "span+1": span + 1}.get(n, n) for n in nv]
            n_valid = torch.tensor(nv, dtype=torch.int32, device="cuda")
            combined = decode_attention.combine_launches
            got = decode_attention(q, k, v, n_valid)
            torch.cuda.synchronize()
            if decode_attention.combine_launches - combined != int(splits > 1):
                raise AssertionError(f"decode_attention {label}: {splits} splits but "
                                     f"{decode_attention.combine_launches - combined} "
                                     f"combine launches")
            err = kb.attn_err("decode_attention", label, got, decode_attention_ref(q, k, v, n_valid),
                            dtype)
            if 0 in nv and got[nv.index(0)].any():
                raise AssertionError(f"decode_attention {label}: n_valid = 0 row not zero")
            max_err["decode_attention"] = max(max_err["decode_attention"], err)
            log(f"  decode_attention == twin at {label} (B {b}, C {c}, H {h}, K {kv}, "
                f"hd {hd}, n_valid {nv}, {splits} split(s) of {span}) {str(dtype)[6:]}: "
                f"max err {err:.3e}")
            del q, k, v, got
        for label, b, sq, sk, h, kv, hd, causal, window in FLASH_SHAPES:
            q = torch.randn(b, sq, h, hd, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(b, sk, kv, hd, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            got = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = kb.attn_err("flash_attention", label, got,
                            attention_ref(q, k, v, causal=causal, window=window), dtype)
            max_err["flash_attention"] = max(max_err["flash_attention"], err)
            log(f"  flash_attention == twin at {label} (B {b}, Sq {sq}, Sk {sk}, H {h}, "
                f"K {kv}, hd {hd}, causal {causal}, window {window}) {str(dtype)[6:]}: "
                f"max err {err:.3e}")
            del q, k, v, got
            torch.cuda.empty_cache()
    max_err["decode_attention_combine"] = check_combine()
    return max_err


def check_combine() -> float:
    """The split path's combine kernel against its twin, fp32 within 1e-5
    and bf16 within 1.6e-2 (relative, as the attention checks), an
    all-empty row exactly zero."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for dtype, (splits, b, h, hd) in itertools.product(
            (torch.bfloat16, torch.float32), ((7, 8, 15, 64), (8, 7, 15, 64), (3, 2, 10, 256))):
        acc, ml = combine_inputs(splits, b, h, hd, gen)
        got = combine_partials(acc, ml, torch.empty(b, 1, h, hd, dtype=dtype, device="cuda"))
        torch.cuda.synchronize()
        err = kb.attn_err("decode_attention_combine", f"{splits} splits", got,
                        combine_partials_ref(acc, ml[0], ml[1], dtype), dtype)
        if got[0].any():
            raise AssertionError("decode_attention_combine: an all-empty row is not zero")
        worst = max(worst, err)
        log(f"  decode_attention_combine == twin at {splits} splits (B {b}, H {h}, hd {hd}) "
            f"{str(dtype)[6:]}: max err {err:.3e}")
    return worst


# WKV-6 cases: (label, B, S, H, decay): the reference suite's shapes
# (tests/test_kernels.py: bh 4/2/3/1 at S 128/256/64/512, here B 1 with
# H = bh), S = 1, an S that is not a multiple of 64, S either side of the
# kernel's 16-step chunk, strong decay (log_w = -e^10, the model's clip)
# and none (log_w ~ 0), then RWKV6-7B's prefill and decode shapes (B 8, H
# 64), strong decay at the prefill shape, and S 4096
WKV_SHAPES = [
    ("test 4x128", 1, 128, 4, "random"), ("test 2x256", 1, 256, 2, "random"),
    ("test 3x64", 1, 64, 3, "random"), ("test 1x512", 1, 512, 1, "random"),
    ("S 1", 2, 1, 3, "random"), ("S 200", 2, 200, 3, "random"),
    ("S 15", 2, 15, 3, "random"), ("S 17", 2, 17, 3, "random"),
    ("strong decay", 2, 128, 3, "strong"), ("no decay", 2, 128, 3, "none"),
    ("rwkv6-7b prefill", 8, 128, 64, "random"), ("rwkv6-7b decode", 8, 1, 64, "random"),
    ("rwkv6-7b prefill", 8, 128, 64, "strong"), ("S 4096", 8, 4096, 64, "random"),
]
# RG-LRU cases: (label, B, S, W): the reference suite's, RecurrentGemma-2B's
# prefill and decode shapes (B 8, W 2560), S 4096, a width that is not a
# multiple of the kernel's 32 channels a warp (with S not a multiple of
# its 32-step tile), one that is not a multiple of 4 (4-byte copies), and
# S one past a tile
LRU_SHAPES = [
    ("test 2x128x256", 2, 128, 256), ("test 3x64x128", 3, 64, 128),
    ("test 2x256x384", 2, 256, 384), ("test 1x512x128", 1, 512, 128),
    ("recurrentgemma prefill", 8, 128, 2560), ("recurrentgemma decode", 8, 1, 2560),
    ("S 4096", 8, 4096, 2560), ("W 200", 2, 100, 200), ("W 199", 3, 45, 199),
    ("S 33", 2, 33, 256),
]


def _scan_err(name: str, label: str, got, want) -> float:
    atol, rtol = SCAN_TOL[name]
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name} {label}: bad output {tuple(g.shape)}")
        excess = float(((g - w).abs() - (atol + rtol * w.abs())).max())
        if excess > 0:
            raise AssertionError(f"{name} {label}: off the twin by "
                                 f"{float((g - w).abs().max())}")
        err = max(err, float((g - w).abs().max()))
    return err


def check_scan_kernels() -> dict:
    """WKV-6 and the RG-LRU scan against their twins on the card, at the
    reference suite's shapes, the edge cases and the serving paths'."""
    max_err = {"wkv6": 0.0, "rglru_scan": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for label, b, s, h, decay in WKV_SHAPES:
        args = wkv_inputs(b, s, h, decay, gen)
        got = wkv6(*args)
        torch.cuda.synchronize()
        err = _scan_err("wkv6", label, got, wkv_twin(*args))
        if decay == "strong":  # exp(-e^10) = 0: only the last k v^T is left
            kv = args[1][:, -1, :, :, None] * args[2][:, -1, :, None, :]
            _scan_err("wkv6", f"{label} (state = last k v^T)", got[1:], (kv,))
        max_err["wkv6"] = max(max_err["wkv6"], err)
        log(f"  wkv6 == twin at {label} (B {b}, S {s}, H {h}, {decay} decay): "
            f"y and S_final max err {err:.3e}")
    for label, b, s, w in LRU_SHAPES:
        args = lru_inputs(b, s, w, gen)
        got, want = rglru_scan(*args), rglru_ref(*args)
        err = _scan_err("rglru_scan", label, got, want)
        if not all(torch.equal(g, x) for g, x in zip(got, want)):
            raise AssertionError(f"rglru_scan {label}: not bitwise equal to the twin")
        max_err["rglru_scan"] = max(max_err["rglru_scan"], err)
        log(f"  rglru_scan == twin bitwise at {label} (B {b}, S {s}, W {w})")
    # the reference suite's strong decay: log_a = -60 forgets h0 = 1e6 in a step
    log_a = torch.full((1, 64, 128), -60.0, device="cuda")
    h, _ = rglru_scan(log_a, torch.ones_like(log_a), torch.full((1, 128), 1e6, device="cuda"))
    torch.cuda.synchronize()
    if not torch.isfinite(h).all() or float((h[:, 1:] - 1.0).abs().max()) > 1e-5:
        raise AssertionError("rglru_scan strong decay: h not finite and 1 after step 0")
    log("  rglru_scan strong decay (log_a -60, h0 1e6): finite, h = 1 from step 1 on")
    torch.cuda.empty_cache()
    return max_err


def zero_counts() -> None:
    for wrapper in WRAPPERS:
        wrapper.launches = 0
    decode_attention.combine_launches = 0


def launch_counts() -> dict:
    """Every wrapper's count since :func:`zero_counts` (the two-pass
    route's under its wire stage's name and ``round_mix``)."""
    got = {w.__name__: w.launches for w in WRAPPERS}
    got["decode_attention_combine"] = decode_attention.combine_launches
    return got


def expect_launches(what: str, **want: int) -> None:
    """Every wrapper's count since :func:`zero_counts` is ``want`` (0 for
    the ones not named): so no path but this PR's large federations takes
    the two-pass route."""
    torch.cuda.synchronize()
    got = launch_counts()
    full = {name: want.get(name, 0) for name in got}
    if got != full:
        raise AssertionError(f"{what}: launches {got}, want {full}")


def falling(what: str, losses) -> str:
    """Each round's loss is one 20-sample batch per hospital, so compare
    the means of the first and the last five rounds."""
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not all(math.isfinite(v) for v in losses) or not last < first:
        raise AssertionError(f"{what}: loss not finite and falling: {losses}")
    return f"loss (mean of 5 rounds) {first:.4f} -> {last:.4f}"


def against_cpu(what: str, out: dict, **kw) -> None:
    """The same run on the CPU twins: the kernels must not move the result
    beyond what fp32 summation order does (an int8 step that flips at a
    rounding boundary, or a top-k near-tie that flips, is absorbed by
    error feedback)."""
    cpu = run_fused_engine(device="cpu", **kw)
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], cpu["losses"]))
    if rel > 1e-2 or abs(out["bal_acc"] - cpu["bal_acc"]) > 0.02:
        raise AssertionError(
            f"{what}: cuda run drifts from the cpu run: loss rel {rel}, bal_acc "
            f"{out['bal_acc']} vs {cpu['bal_acc']}")
    log(f"  {what} cuda vs cpu twins: max loss rel diff {rel:.2e}, "
        f"bal_acc {out['bal_acc']:.4f} vs {cpu['bal_acc']:.4f}")


def dsgd_run(rounds: int = 3, device: str = "cuda", **kw):
    data = generate_ehr_cohort(seed=0)
    run = FLRunConfig(algorithm="dsgd", q=10, topology="hospital20", n_nodes=20,
                      batch_per_node=20, alpha0=0.02)
    return train_decentralized(
        make_mlp_loss(class_weights()), mlp_init(0, device=device), run,
        make_node_batcher(data, m=20, seed=1), rounds=rounds, engine="fused",
        device=device, **kw)


def main_path() -> dict:
    """The port's main path through its user entry points; counts are
    zeroed just before each run and read just after."""
    zero_counts()
    out = run_fused_engine(rounds=20, q=10, device="cuda")
    expect_launches("FD-DSGT", fused_round_gt=20)
    if out["wire_bytes"] != WIRE_DSGT:
        raise AssertionError(f"FD-DSGT wire bytes {out['wire_bytes']} != {WIRE_DSGT}")
    log(f"  FD-DSGT 20 rounds x Q=10: 20 fused_round_gt launches, "
        f"wire {out['wire_bytes']:.0f} B/round, {falling('FD-DSGT', out['losses'])}, "
        f"final bal_acc={out['bal_acc']:.4f}")
    against_cpu("FD-DSGT", out, rounds=20, q=10)

    zero_counts()
    res = dsgd_run()
    expect_launches("FD-DSGD", fused_round=3)
    per_round = res.history.column("comm_bytes")[-1] / 3
    loss = res.history.column("loss")
    if per_round != WIRE_DSGD or not np.isfinite(loss).all():
        raise AssertionError(f"FD-DSGD wire {per_round} / losses {loss}")
    log(f"  FD-DSGD 3 rounds x Q=10: 3 fused_round launches, wire "
        f"{per_round:.0f} B/round, losses {np.round(loss, 4).tolist()}")
    return {"fused_round": 3, "fused_round_gt": 20, "sequential_losses": out["losses"],
            "fp32_runs": {"FD-DSGT sequential": out}}


def stale_paths(sequential_losses, fp32_runs: dict) -> dict:
    """The bounded-staleness, pipelined and top-k paths, each through its
    user entry point, with its launches counted; the k = 2 and top-64
    runs go into ``fp32_runs`` for phase 7."""
    zero_counts()
    out = run_fused_engine(rounds=20, q=10, device="cuda",
                           fl_schedule="bounded_staleness:k=2")
    fp32_runs["FD-DSGT bounded_staleness:k=2"] = out
    expect_launches("FD-DSGT k=2", wire_stage_gt=20)
    if out["wire_bytes"] != WIRE_DSGT:
        raise AssertionError(f"FD-DSGT k=2 wire bytes {out['wire_bytes']} != {WIRE_DSGT}")
    log(f"  FD-DSGT bounded_staleness:k=2, 20 rounds x Q=10: 20 wire_stage_gt "
        f"launches, 0 fused_round_gt, wire {out['wire_bytes']:.0f} B/round, "
        f"{falling('FD-DSGT k=2', out['losses'])}, final bal_acc={out['bal_acc']:.4f}")
    against_cpu("FD-DSGT k=2", out, rounds=20, q=10, fl_schedule="bounded_staleness:k=2")

    zero_counts()
    res = dsgd_run(staleness_depth=4)
    expect_launches("FD-DSGD k=4", wire_stage=3)
    per_round = res.history.column("comm_bytes")[-1] / 3
    loss = res.history.column("loss")
    if (per_round != WIRE_DSGD or not np.isfinite(loss).all()
            or res.engine.round_schedule.spec() != "bounded_staleness:k=4"):
        raise AssertionError(f"FD-DSGD k=4 wire {per_round} / losses {loss}")
    log(f"  FD-DSGD staleness_depth=4, 3 rounds x Q=10: 3 wire_stage launches, "
        f"wire {per_round:.0f} B/round, losses {np.round(loss, 4).tolist()}")

    zero_counts()
    out = run_fused_engine(rounds=5, q=10, device="cuda", fl_schedule="pipelined")
    expect_launches("FD-DSGT pipelined", fused_round_gt=5)
    # the first round's loss comes before any mix; from the second on the
    # one-round-stale mix must show
    if out["losses"][0] != sequential_losses[0] or np.allclose(
            out["losses"][1:], sequential_losses[1:5], rtol=1e-6, atol=0):
        raise AssertionError(f"FD-DSGT pipelined losses {out['losses']} vs "
                             f"sequential {sequential_losses[:5]}")
    log(f"  FD-DSGT pipelined, 5 rounds x Q=10: 5 fused_round_gt launches with "
        f"stale_mix, losses {np.round(out['losses'], 4).tolist()} (sequential "
        f"{np.round(sequential_losses[:5], 4).tolist()})")
    against_cpu("FD-DSGT pipelined", out, rounds=5, q=10, fl_schedule="pipelined")

    zero_counts()
    out = run_fused_engine(rounds=5, q=10, device="cuda", topk=TOPK_MAIN)
    expect_launches("FD-DSGT top-64", fused_round_gt=5)
    fp32_runs["FD-DSGT top-64"] = out
    if out["wire_bytes"] != WIRE_TOP64 or round(out["wire_saving"], 2) != 14.57:
        raise AssertionError(f"FD-DSGT top-64 wire {out['wire_bytes']}, saving "
                             f"{out['wire_saving']}")
    log(f"  FD-DSGT top-64, 5 rounds x Q=10: 5 fused_round_gt launches, wire "
        f"{out['wire_bytes']:.0f} B/round ({out['wire_saving']:.2f}x under fp32), "
        f"losses {np.round(out['losses'], 4).tolist()}")
    against_cpu("FD-DSGT top-64", out, rounds=5, q=10, topk=TOPK_MAIN)
    return {"wire_stage": 3, "wire_stage_gt": 20}


def fig2_path(host: dict) -> None:
    """The paper's Fig. 2 through the port's driver on the card: the four
    algorithms at full width for the paper's 3000 iterations on the
    exact-wire tree engine, which launches none of the hand kernels;
    claims 1-2 of the driver hold, and the final losses match the same
    run on the CPU (``host_references``) within FIG2_RTOL. Then the
    trainer with no engine and no device named: the tree engine, on the
    card."""
    zero_counts()
    t0 = time.perf_counter()
    res = fig2_run(iterations=FIG2_ITERATIONS, device="cuda")
    gpu_s = time.perf_counter() - t0
    expect_launches("Fig. 2 (tree engine)")
    checked = claims(res)
    if not (checked["1"]["holds"] and checked["2"]["holds"]):
        raise AssertionError(f"Fig. 2 claims on the card: {checked}")
    log(f"  Fig. 2, {FIG2_ITERATIONS} iterations x 4 algorithms on the tree engine "
        f"in {gpu_s:.1f} s: no hand-kernel launch; claim 1 savings "
        + ", ".join(f"{k} {v:.0f}x" for k, v in checked["1"]["saving"].items())
        + "; claim 2 gap DSGT {DSGT:.4e} < DSGD {DSGD:.4e}".format(**checked["2"]["gap"]))
    cpu, cpu_s = host["fig2"], host["fig2_s"]
    rel = {}
    for name in ALGOS:
        a, b = res[name]["final_loss"], cpu[name]["final_loss"]
        rel[name] = abs(a - b) / abs(b)
        if rel[name] > FIG2_RTOL or not math.isfinite(a):
            raise AssertionError(f"Fig. 2 {name}: final loss {a} on the card, {b} "
                                 f"on the CPU")
    log(f"  Fig. 2 final losses, card vs CPU ({cpu_s:.1f} s while the kernels built): "
        + ", ".join(f"{k} {res[k]['final_loss']:.6f} ({v:.1e})" for k, v in rel.items()))

    zero_counts()
    data = generate_ehr_cohort(seed=0)
    run = FLRunConfig(algorithm="dsgt", q=1, topology="hospital20", n_nodes=20,
                      batch_per_node=20, alpha0=0.02)
    out = train_decentralized(make_mlp_loss(), mlp_init(0, device="cuda"), run,
                              make_node_batcher(data, m=20, seed=1), rounds=3)
    expect_launches("trainer defaults")
    state = [l for _, l in tree_leaves(out.state.params)]
    if out.engine.name != "tree" or any(l.device.type != "cuda" for l in state):
        raise AssertionError(f"trainer defaults: engine {out.engine.name}, "
                             f"state on {[l.device for l in state]}")
    log("  train_decentralized() with no engine or device named: the tree engine, "
        "state on the card")


def composition_run(rounds: int, q: int = 10):
    """FD-DSGT as the reference suite's composition oracle, on the card:
    the flat engine with an identity mix runs the local steps and the bare
    tracker / parameter update, then each wire goes through one
    ``make_compressed_flat_gossip`` round (one ``gossip_mix`` launch).
    Same cohort, init, loss, batches and alpha as ``run_fused_engine``.
    Returns (node-stacked params tree, per-round losses)."""
    n, chunk = 20, 512
    batcher = make_node_batcher(generate_ehr_cohort(seed=0), m=20, seed=1)
    flat, layout = pack(stack_for_nodes(mlp_init(0, device="cuda"), n), pad_to=chunk)
    cfg = FLConfig(algorithm="dsgt", q=q, n_nodes=n)
    round_fn = make_fl_round(make_mlp_loss(class_weights()), inv_sqrt(0.02), cfg,
                             FlatEngine(lambda f: f, layout, device="cuda"))
    gossip = make_compressed_flat_gossip(mixing_matrix("hospital20", n), scale_chunk=chunk)
    state = init_fl_state(cfg, flat)
    wire_x, wire_t = init_flat_compression_state(flat), init_flat_compression_state(flat)
    losses = []
    for _ in range(rounds):
        state, m = round_fn(state, stack_batches(batcher, q))
        losses.append(float(m["loss"]))
        px, wire_x = gossip(state.params, wire_x)
        pt, wire_t = gossip(state.tracker, wire_t)
        state = state._replace(params=px, tracker=pt)
    return unpack(state.params, layout), losses


def max_param_diff(a, b) -> float:
    return max(float((x - y).abs().max())
               for (_, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)))


def compressed_path() -> dict:
    """The compressed FD-DSGT path: 5 rounds at Q = 10 launch gossip_mix
    exactly twice a round (and nothing else); held against the fused
    engine's FD-DSGT at the same seed: one round within 1e-5, five rounds
    within the multi-round tolerances (loss rtol 1e-3, params 1e-3)."""
    zero_counts()
    params, losses = composition_run(rounds=5)
    expect_launches("compressed FD-DSGT", gossip_mix=10)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"compressed FD-DSGT losses {losses}")
    fused = run_fused_engine(rounds=5, q=10, device="cuda")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, fused["losses"]))
    diff5 = max_param_diff(params, fused["params"])
    if rel > 1e-3 or diff5 > 1e-3:
        raise AssertionError(f"compressed FD-DSGT vs fused: loss rel {rel}, "
                             f"params {diff5}")
    one, _ = composition_run(rounds=1)
    diff1 = max_param_diff(one, run_fused_engine(rounds=1, q=10, device="cuda")["params"])
    if diff1 > 1e-5:
        raise AssertionError(f"compressed FD-DSGT vs fused after one round: {diff1}")
    log(f"  compressed FD-DSGT (flat engine + make_compressed_flat_gossip), 5 rounds "
        f"x Q=10: 10 gossip_mix launches; vs the fused engine: params max diff "
        f"{diff1:.2e} after 1 round, {diff5:.2e} after 5, loss rel {rel:.2e}, "
        f"losses {np.round(losses, 4).tolist()}")
    return {"gossip_mix": 10}


def _bal_acc(consensus: dict, data) -> float:
    """Balanced accuracy of a consensus MLP on every patient of a cohort."""
    dev = consensus["fc1"]["w"].device
    x = torch.as_tensor(np.concatenate(data.features), device=dev)
    y = torch.as_tensor(np.concatenate(data.labels), device=dev)
    return float(mlp_balanced_accuracy(consensus, x, y))


def _held(what: str, losses, cpu_losses, bal: float, cpu_bal: float) -> str:
    """The multi-round tolerances against the host CPU's run: loss within
    LOSS_RTOL relative, bal_acc within BAL_ACC_TOL."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    if (not all(math.isfinite(x) for x in losses) or rel > LOSS_RTOL
            or abs(bal - cpu_bal) > BAL_ACC_TOL):
        raise AssertionError(f"{what}: losses {losses} vs the host CPU's {cpu_losses} "
                             f"(rel {rel}), bal_acc {bal} vs {cpu_bal}")
    return f"loss rel {rel:.2e}, bal_acc {bal:.4f} vs {cpu_bal:.4f}"


def large_federation_train(algorithm: str, device: str, data):
    """(L1)'s run: ``train_decentralized(engine="fused")`` of the MLP on
    LARGE_HOSPITALS hospitals on a ring, LARGE_ROUNDS rounds at Q = 10."""
    run = FLRunConfig(algorithm=algorithm, q=10, topology="ring", n_nodes=LARGE_HOSPITALS,
                      batch_per_node=20, alpha0=0.02)
    return train_decentralized(make_mlp_loss(class_weights()), mlp_init(0, device=device),
                               run, make_node_batcher(data, m=20, seed=1),
                               rounds=LARGE_ROUNDS, engine="fused", device=device)


def large_gossip_errs(device: str) -> list:
    """(L1)'s gossip stage: ``make_compressed_flat_gossip`` on a perturbed
    init of the LARGE_HOSPITALS ring, the consensus error of each of
    LARGE_ROUNDS rounds."""
    n = LARGE_HOSPITALS
    stacked = stack_for_nodes(mlp_init(0, device="cpu"), n, perturb=0.1,
                              generator=torch.Generator().manual_seed(5))
    flat, _ = pack(stacked, pad_to=512)
    flat = flat.to(device)
    gossip = make_compressed_flat_gossip(mixing_matrix("ring", n), scale_chunk=512)
    st, errs = init_flat_compression_state(flat), []
    for _ in range(LARGE_ROUNDS):
        flat, st = gossip(flat, st)
        dev = flat - flat.mean(dim=0)
        errs.append(float((dev * dev).sum(dim=1).mean()))
    return errs


def large_federation_path(cpu: dict) -> dict:
    """(L1) The MLP at full width (42 -> 32 -> 2) across LARGE_HOSPITALS
    hospitals on a ring (the EHR cohort cut into that many sites, about
    40 patients each), a federation the one-pass plan refuses: FD-DSGT
    and FD-DSGD through ``train_decentralized(engine="fused")``, 5 rounds
    at Q = 10, two launches a round (the wire stage and the mix), each
    held to the same run on the host CPU's twins; then the gossip stage
    (``make_compressed_flat_gossip``) on a perturbed init of the same
    federation (``stack_for_nodes(perturb=)``), 5 rounds, two launches a
    round, its consensus error a round against the host CPU's (``cpu``:
    :func:`phase3_host`'s runs)."""
    n, rounds = LARGE_HOSPITALS, LARGE_ROUNDS
    data = generate_ehr_cohort(seed=0, n_hospitals=n)
    counts = {"round_mix": 0}
    for algorithm, name in (("dsgt", "fused_round_gt"), ("dsgd", "fused_round")):
        zero_counts()
        t0 = time.perf_counter()
        res = large_federation_train(algorithm, "cuda", data)
        card_s = time.perf_counter() - t0
        wire = kb.ROUTE_WIRES[name][0].__name__
        expect_launches(f"(L1) FD-{algorithm.upper()} at {n} hospitals",
                        **{wire: rounds, "round_mix": rounds})
        counts[wire] = rounds
        counts["round_mix"] += rounds
        route = kb.route_plan(name, n, res.engine.layout.total, 512, None)[0]
        cpu_losses, cpu_bal = cpu[("(L1)", algorithm)]
        note = _held(f"(L1) FD-{algorithm.upper()}", list(res.history.column("loss")),
                     cpu_losses, _bal_acc(res.consensus, data), cpu_bal)
        log(f"  (L1) FD-{algorithm.upper()} on {n} hospitals ({sum(map(len, data.labels)):,} "
            f"patients), a ring, ({n}, {res.engine.layout.total}) at chunk 512, route "
            f"{route}: {rounds} {wire} + {rounds} round_mix launches in {rounds} "
            f"rounds ({card_s:.1f} s); against the host CPU: {note}")
        del res

    zero_counts()
    errs = {"cuda": large_gossip_errs("cuda"), "cpu": cpu[("(L1)", "gossip")]}
    expect_launches(f"(L1) gossip stage at {n} nodes", wire_stage_gossip=rounds,
                    round_mix=rounds)
    rel = max(abs(a - b) / abs(b) for a, b in zip(errs["cuda"], errs["cpu"]))
    if rel > LOSS_RTOL or not errs["cuda"][-1] < errs["cuda"][0]:
        raise AssertionError(f"(L1) gossip stage: consensus errors {errs['cuda']} vs the "
                             f"host CPU's {errs['cpu']}")
    counts["wire_stage_gossip"] = rounds
    counts["round_mix"] += rounds
    log(f"  (L1) make_compressed_flat_gossip at {n} nodes, a perturbed init "
        f"(perturb 0.1): {rounds} wire_stage_gossip + {rounds} round_mix launches; "
        f"consensus error {errs['cuda'][0]:.4e} -> {errs['cuda'][-1]:.4e}, against the host "
        f"CPU's rel {rel:.2e}")
    return counts


def wire_knob_paths(group, cpu_group) -> dict:
    """(L2) item 9's knobs, each (error_feedback, difference_coding) with a
    knob off: FD-DSGT on the paper's 20 hospitals, 5 rounds at Q = 10,
    sequential and bounded staleness k = 2, on ``fused`` (hospital20's W)
    and on one-rank ``sharded_fused`` over the all-gather wire (the same
    W) and the circulant torus (a ring of 20), each held to the same run
    on the host CPU (the twins; a gloo group for the sharded runs) within
    the multi-round tolerances, its launches counted."""
    data = generate_ehr_cohort(seed=0)
    counts = {}
    for (ef, dc), schedule in itertools.product(KNOB_RUNS, ("sequential",
                                                             "bounded_staleness:k=2")):
        knobs = dict(error_feedback=ef, difference_coding=dc, fl_schedule=schedule)
        tag = f"ef={int(ef)} dc={int(dc)} {schedule}"
        fused_kernel = "fused_round_gt" if schedule == "sequential" else "wire_stage_gt"
        zero_counts()
        out = run_fused_engine(rounds=5, q=10, device="cuda", **knobs)
        expect_launches(f"(L2) fused {tag}", **{fused_kernel: 5})
        cpu = run_fused_engine(rounds=5, q=10, device="cpu", **knobs)
        notes = [f"fused {_held(f'(L2) fused {tag}', out['losses'], cpu['losses'], out['bal_acc'], cpu['bal_acc'])}"]
        counts[fused_kernel] = counts.get(fused_kernel, 0) + 5
        for wire, w in (("all-gather", "hospital20"), ("torus", None)):
            zero_counts()
            got = run_sharded_engine(group, 5, 10, w=w, log=False, **knobs)
            expect_launches(f"(L2) sharded {wire} {tag}", wire_stage_gt=5)
            host = run_sharded_engine(cpu_group, 5, 10, w=w, log=False, **knobs)
            bal = [_bal_acc(tree_map(lambda p: p.mean(dim=0),
                                     r["engine"].params_view(r["state"].params)), data)
                   for r in (got, host)]
            notes.append(f"sharded {wire} " + _held(f"(L2) sharded {wire} {tag}",
                                                    got["losses"], host["losses"], *bal))
            counts["wire_stage_gt"] = counts.get("wire_stage_gt", 0) + 5
        log(f"  (L2) {tag}, 5 rounds: " + "; ".join(notes))
    return counts


def dynamic_run(device: str, algorithm: str, schedule: str, topology_program,
                node_program, rounds: int) -> dict:
    """One dynamic run through the library's entry points: the fused
    engine under the programs, ``make_fl_round``, ``rounds`` rounds of Q
    = 10 on the paper's cohort and graph. Records each round's realized
    W_off (the engine's ``_round_gates`` of the comm state the round
    enters), the losses, the wire bytes and the realized fractions."""
    cfg = FLConfig(algorithm=algorithm, q=10, n_nodes=20)
    engine, flat = get_engine("fused").simulated(
        mixing_matrix("hospital20", 20), stack_for_nodes(mlp_init(0, device=device), 20),
        scale_chunk=512, round_schedule=schedule, topology_program=topology_program,
        node_program=node_program)
    round_fn = make_fl_round(make_mlp_loss(class_weights()), inv_sqrt(0.02), cfg, engine)
    state = init_fl_state(cfg, flat, engine)
    batcher = make_node_batcher(generate_ehr_cohort(seed=0), m=20, seed=1)
    w_offs, losses, fracs = [], [], {}
    for _ in range(rounds):
        w_offs.append(engine._round_gates(state.comm)[0])
        state, m = round_fn(state, stack_batches(batcher, cfg.q))
        losses.append(m["loss"])
        for k in ("edge_fraction", "payload_fraction", "compute_fraction"):
            if k in m:
                fracs.setdefault(k, []).append(m[k])
    return {"w_off": torch.stack(w_offs).cpu(), "losses": torch.stack(losses).tolist(),
            "wire_bytes": m["wire_bytes"],
            "fractions": {k: torch.stack(v).tolist() for k, v in fracs.items()}}


def dynamic_paths() -> dict:
    """The dynamic rounds on the card, each against the same run on the
    CPU twins: the launches (one kernel a round), the realized W_off
    sequence bitwise, the fractions equal, the losses within 1e-2
    relative, the wire bytes unchanged."""
    launches = {}
    for label, algorithm, schedule, tp, npg, rounds, kernel in DYNAMIC_RUNS:
        zero_counts()
        card = dynamic_run("cuda", algorithm, schedule, tp, npg, rounds)
        expect_launches(label, **{kernel: rounds})
        launches[kernel] = launches.get(kernel, 0) + rounds
        cpu = dynamic_run("cpu", algorithm, schedule, tp, npg, rounds)
        same_w = torch.equal(card["w_off"].view(torch.int32), cpu["w_off"].view(torch.int32))
        rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
        want_bytes = WIRE_DSGT if algorithm == "dsgt" else WIRE_DSGD
        losses = card["losses"]
        if (not same_w or card["fractions"] != cpu["fractions"] or rel > 1e-2
                or card["wire_bytes"] != want_bytes
                or not all(math.isfinite(v) for v in losses)):
            raise AssertionError(
                f"{label}: W_off bitwise {same_w}, fractions {card['fractions']} vs "
                f"{cpu['fractions']}, loss rel {rel}, wire {card['wire_bytes']}")
        means = ", ".join(f"{k} {np.mean(v):.4f}" for k, v in card["fractions"].items())
        log(f"  {label} ({schedule}, {tp or npg}), {rounds} rounds x Q=10: {rounds} "
            f"{kernel} launches, W_off of every round bitwise the CPU's, {means}, "
            f"wire {card['wire_bytes']:.0f} B/round, losses {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, max rel diff to the CPU {rel:.2e}")
    return launches


def program_edge_fraction(spec: str, rounds: int) -> float:
    """The mean realized edge fraction of ``rounds`` rounds of a topology
    program on the hospital graph, from the program alone on the CPU
    (the oracle the tests hold to the reference bit for bit)."""
    prog = parse_program(spec).bind(mixing_matrix("hospital20", 20), device="cpu")
    key = _as_key(prog.init_key())
    state = {k: torch.as_tensor(v) for k, v in prog.init_state().items()}
    fracs = []
    for r in range(rounds):
        w_off, _, state = prog.round_weights_state(r, key, state)
        fracs.append(prog.edge_fraction(w_off))
    return float(np.mean(torch.stack(fracs).tolist()))


def _committed(name: str) -> list:
    with open(os.path.join(ROOT, "experiments", f"{name}.json")) as f:
        return json.load(f)["cells"]


def _check_fraction(what: str, got: float, want: float) -> None:
    if not abs(got - want) <= DRIVER_FRACTION_TOL:
        raise AssertionError(f"{what}: realized fraction {got!r}, want {want!r}")


def driver_paths() -> None:
    """The three EHR round-axis drivers in full on the card: staleness (6
    cells, 320 iterations each), churn (5 cells x 120 rounds), straggler
    (13 cells x 80 rounds). Launches counted per driver; the realized
    fractions held to the committed JSONs (the JSON's node_churn cells
    predate the reference's Markov chain, so those are held to the
    program's own fractions and the JSON's printed beside); bal_acc
    printed beside the JSON's."""
    t0 = time.perf_counter()
    zero_counts()
    rec = staleness_ehr.run(320, device="cuda", log=False)
    expect_launches("staleness driver", fused_round_gt=840)
    for cell, ref in zip(rec["cells"], _committed("staleness_ehr")):
        if not math.isfinite(cell["bal_acc"]) or cell["iterations"] != ref["iterations"]:
            raise AssertionError(f"staleness cell {cell}")
        log(f"  staleness Q={cell['q']:2d} {cell['schedule']:10s}: bal_acc "
            f"{cell['bal_acc']:.4f} (JSON {ref['bal_acc']:.4f})")

    zero_counts()
    rec = churn_ehr.run(120, 10, device="cuda", log=False)
    expect_launches("churn driver", fused_round_gt=600)
    json_cells = {c["program"]: c for c in _committed("churn_ehr")}
    for cell in rec["cells"]:
        ref = json_cells[cell["program"]]
        got = cell["mean_edge_fraction"]
        if cell["program"].startswith("node_churn"):
            _check_fraction(cell["program"], got, program_edge_fraction(cell["program"], 120))
            note = f"(the program's own; JSON {ref['mean_edge_fraction']:.6f} predates the chain)"
        else:
            _check_fraction(cell["program"], got, ref["mean_edge_fraction"])
            note = f"(JSON {ref['mean_edge_fraction']:.6f})"
        log(f"  churn {cell['program']}: edges up {got:.6f} {note}, bal_acc "
            f"{cell['bal_acc']:.4f} (JSON {ref['bal_acc']:.4f})")

    zero_counts()
    rec = straggler_ehr.run(80, 10, device="cuda", log=False)
    expect_launches("straggler driver", fused_round_gt=480, wire_stage_gt=560)
    for cell, ref in zip(rec["cells"], _committed("straggler_ehr")):
        if (cell["schedule"], cell["node_program"], cell["robust_alpha"]) != (
                ref["schedule"], ref["node_program"], ref["robust_alpha"]):
            raise AssertionError(f"straggler cells out of order: {cell} vs {ref}")
        for k in ("mean_payload_fraction", "mean_compute_fraction"):
            _check_fraction(f"straggler {cell['schedule']} {cell['node_program']} {k}",
                            cell[k], ref[k])
        log(f"  straggler k={cell['staleness_depth']} frac={cell['straggler_fraction']}"
            f"{' robust_alpha' if cell['robust_alpha'] else ''}: payload "
            f"{cell['mean_payload_fraction']:.6f}, compute "
            f"{cell['mean_compute_fraction']:.6f} (= JSON), bal_acc "
            f"{cell['bal_acc']:.4f} (JSON {ref['bal_acc']:.4f})")
    log(f"  the three drivers in {time.perf_counter() - t0:.1f} s: 840 + 600 + 480 "
        "fused_round_gt, 560 wire_stage_gt launches")


def fused_oracle(algorithm: str, schedule: str, topk, rounds: int = SHARDED_ROUNDS,
                 q: int = 10, device: str = "cuda", scale_chunk: int = 512, w=None, **axes):
    """The port's FusedEngine on ``device`` with ``run_sharded_engine``'s
    defaults: hospital20 (or ``w``), mlp_init(0), the cohort of seed 0 and
    its batcher of seed 1, the balanced loss, alpha = 0.02/sqrt(r);
    ``axes`` the topology program, node program, privacy spec and scope.
    Returns (final state, per-round losses, last metrics)."""
    batcher = make_node_batcher(generate_ehr_cohort(seed=0), m=20, seed=1)
    cfg = FLConfig(algorithm=algorithm, q=q, n_nodes=20)
    eng, flat = FusedEngine.simulated(
        mixing_matrix("hospital20", 20) if w is None else w,
        stack_for_nodes(mlp_init(0, device=device), 20),
        scale_chunk=scale_chunk, topk=topk, round_schedule=schedule, **axes)
    round_fn = make_fl_round(make_mlp_loss(class_weights()), inv_sqrt(0.02), cfg, eng)
    state, losses = init_fl_state(cfg, flat, eng), []
    for _ in range(rounds):
        state, m = round_fn(state, stack_batches(batcher, q))
        losses.append(float(m["loss"]))
    return state, losses, m


def sharded_path(group) -> dict:
    """The sharded engine through its entry points (``from_group``,
    ``init_fl_state``, ``make_fl_round``, as ``run_sharded_engine`` calls
    them) on a one-rank NCCL group, the paper's configuration, 5 rounds
    at Q = 10: FD-DSGD and FD-DSGT, sequential and pipelined, top-16
    (positions) and top-64 (bitmap) -- ONE compact wire-stage launch per
    round and no other gossip kernel, 3 all-gathers per wire and round
    handed 20 x flat_wire_bytes bytes each per wire, the table's wire
    bytes, the loss within rtol 1e-3 of the fused engine on the card
    every round (the multi-round tolerance: exact ties of the MLP's output
    columns make the compact wire keep k of them where the fused engine's
    mask keeps all); then the dense int8 wire (one wire_stage /
    wire_stage_gt launch, 2 all-gathers per wire), params and tracker
    within 1e-5 of the fused engine after one round, and after five the
    consensus (node mean) within 1e-3 -- the multi-round tolerances of
    tests/test_torch_schedules.py: the mix sums in another order, and an
    ulp can move a payload across an int8 rounding boundary, a step that
    error feedback absorbs. Counts are zeroed just before each run and
    read just after."""
    launches = {name: 0 for name in COMPACT_KERNELS}
    runs = [(a, s, k) for a in ("dsgd", "dsgt") for s in ("sequential", "pipelined")
            for k in SHARDED_TOPKS] + [("dsgd", "sequential", None),
                                       ("dsgt", "sequential", None)]
    for algorithm, schedule, topk in runs:
        wires = 2 if algorithm == "dsgt" else 1
        kernel = {(True, 1): "wire_stage_compact", (True, 2): "wire_stage_gt_compact",
                  (False, 1): "wire_stage", (False, 2): "wire_stage_gt"}[(topk is not None,
                                                                          wires)]
        label = f"sharded {algorithm.upper()} {schedule} " + (f"top-{topk}" if topk else "int8")
        zero_counts()
        t0 = time.perf_counter()
        out = run_sharded_engine(group, rounds=SHARDED_ROUNDS, q=10, algorithm=algorithm,
                                 topk=topk, fl_schedule=schedule, log=False)
        expect_launches(label, **{kernel: SHARDED_ROUNDS})
        run_s = time.perf_counter() - t0
        eng = out["engine"]
        buffers = 3 if topk else 2
        per_wire = 20 * flat_wire_bytes(eng.layout, 1, 512, topk)
        encoding = {None: "dense", 16: "positions", 64: "bitmap"}[topk]
        if (eng.wire_encoding != encoding
                or eng.collectives != SHARDED_ROUNDS * wires * buffers
                or eng.collective_bytes != SHARDED_ROUNDS * wires * per_wire
                or out["wire_bytes"] != SHARDED_WIRE[(topk, algorithm)]):
            raise AssertionError(
                f"{label}: encoding {eng.wire_encoding}, {eng.collectives} all-gathers of "
                f"{eng.collective_bytes} B, wire {out['wire_bytes']} B/round")
        if kernel in launches:
            launches[kernel] += SHARDED_ROUNDS
        state, losses, _ = fused_oracle(algorithm, schedule, topk)
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], losses))
        diff = float((out["state"].params - state.params).abs().max())
        mean_diff = float((out["state"].params.mean(0) - state.params.mean(0)).abs().max())
        if algorithm == "dsgt":
            diff = max(diff, float((out["state"].tracker - state.tracker).abs().max()))
        if topk is None:
            one = run_sharded_engine(group, rounds=1, q=10, algorithm=algorithm,
                                     fl_schedule=schedule, log=False)["state"]
            want, _, _ = fused_oracle(algorithm, schedule, None, rounds=1)
            diff1 = float((one.params - want.params).abs().max())
            if algorithm == "dsgt":
                diff1 = max(diff1, float((one.tracker - want.tracker).abs().max()))
            if diff1 > 1e-5 or mean_diff > 1e-3:
                raise AssertionError(f"{label} vs the fused engine: params/tracker off by "
                                     f"{diff1} after one round, consensus by {mean_diff} "
                                     "after five")
            log(f"  {label} vs the fused engine after one round: params/tracker max diff "
                f"{diff1:.2e}")
        if not all(math.isfinite(v) for v in out["losses"]) or rel > 1e-3:
            raise AssertionError(f"{label} vs the fused engine: loss rel {rel}, params/"
                                 f"tracker {diff}; losses {out['losses']} vs {losses}")
        log(f"  {label}, {SHARDED_ROUNDS} rounds x Q=10 ({run_s:.2f} s): "
            f"{SHARDED_ROUNDS} {kernel} launches, {eng.collectives} all-gathers "
            f"({buffers} per wire and round) of {eng.collective_bytes // SHARDED_ROUNDS:,} "
            f"B a round, {encoding} wire {out['wire_bytes']:,.0f} B/round; vs the fused "
            f"engine: loss rel {rel:.2e}, params/tracker max diff {diff:.2e}, consensus "
            f"{mean_diff:.2e}")
    return launches


def sharded_quadratic(group) -> None:
    """The reference suite's contract on the card
    (tests/test_sharded_engine.py): the exact-gradient quadratic problem
    on 8 nodes, an Erdos-Renyi W, chunk 16, the dense int8 wire and top-4
    (the bitmap wire), 4 rounds at Q = 2: params and tracker within 1e-5
    of the fused engine on the same W (no non-zero ties at the threshold
    there)."""
    n, q, chunk = 8, 2, 16
    rng = np.random.default_rng(0)
    params = {"w": torch.tensor(rng.normal(size=(n, 4, 5)), dtype=torch.float32,
                                device="cuda"),
              "b": torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device="cuda")}
    batches = {"t": rng.normal(size=(q, n, 4, 5)).astype(np.float32)}

    def loss(p, b):
        return ((p["w"] - b["t"]) ** 2).sum(dim=(1, 2)) + (p["b"] ** 2).sum(dim=1)

    w = mixing_matrix("erdos_renyi", n, p=0.7, seed=1)
    worst = 0.0
    for algorithm, schedule, topk in itertools.product(
            ("dsgd", "dsgt"), ("sequential", "pipelined"), (None, 4)):
        cfg = FLConfig(algorithm=algorithm, q=q, n_nodes=n)
        kw = dict(scale_chunk=chunk, topk=topk, round_schedule=schedule)
        sh, rows = ShardedFusedEngine.from_group(group, params, w=w, **kw)
        fe, flat = FusedEngine.simulated(w, params, **kw)
        states = []
        for eng, start in ((sh, rows), (fe, flat)):
            round_fn = make_fl_round(loss, inv_sqrt(0.05), cfg, eng)
            state = init_fl_state(cfg, start, eng)
            for _ in range(4):
                state, _ = round_fn(state, batches)
            states.append(state)
        a, b = states
        diff = float((a.params - b.params).abs().max())
        if algorithm == "dsgt":
            diff = max(diff, float((a.tracker - b.tracker).abs().max()))
        if sh.wire_encoding != ("bitmap" if topk else "dense") or diff > 1e-5:
            raise AssertionError(f"sharded {algorithm} {schedule} top-{topk} on the "
                                 f"quadratic problem: {sh.wire_encoding} wire, off by {diff}")
        worst = max(worst, diff)
    log(f"  the quadratic contract on the card (8 nodes, chunk 16, int8 and top-4 bitmap "
        f"wires, 4 rounds, DSGD/DSGT x sequential/pipelined): params/tracker within "
        f"{worst:.2e} of the fused engine")


def program_w_offs(engine, rounds: int):
    """The realized W_off of ``rounds`` rounds from ``engine``'s initial
    counters (``_round_gates`` advancing them round by round, as the
    round does), and the counters after them."""
    comm = dict(engine._topo_init())
    w_offs = []
    for _ in range(rounds):
        w_off, _, new_comm, _ = engine._round_gates(comm)
        w_offs.append(w_off)
        comm.update(new_comm)
    return torch.stack(w_offs).cpu(), comm


def sharded_dynamic_path(group, cpu: dict) -> dict:
    """(h) The sharded engine under the programs through
    ``run_sharded_engine``, 5 rounds each at Q = 10 on the one-rank NCCL
    group: ONE wire-stage launch a round and no other gossip kernel; the
    static run's all-gathers and bytes (a program adds no collective);
    the realized W_off of every round bitwise the CPU's (the same
    engine's counters replayed on a gloo group), the run's counters those
    of the replay; the loss within rtol 1e-3 of the fused engine on the
    card under the same program -- ``slow_uplink``, which the fused
    engine refuses, against the same sharded run on the CPU, its
    ``wire_bytes_effective`` equal (``cpu``: :func:`phase3_host`'s)."""
    launches = {}
    for label, algorithm, schedule, topk, axes in SHARDED_DYNAMIC_RUNS:
        wires = 2 if algorithm == "dsgt" else 1
        kernel = {(True, 1): "wire_stage_compact", (True, 2): "wire_stage_gt_compact",
                  (False, 1): "wire_stage", (False, 2): "wire_stage_gt"}[(topk is not None,
                                                                          wires)]
        kw = dict(rounds=SHARDED_ROUNDS, q=10, algorithm=algorithm, topk=topk,
                  fl_schedule=schedule, log=False, **axes)
        zero_counts()
        t0 = time.perf_counter()
        out = run_sharded_engine(group, **kw)
        expect_launches(label, **{kernel: SHARDED_ROUNDS})
        run_s = time.perf_counter() - t0
        launches[kernel] = launches.get(kernel, 0) + SHARDED_ROUNDS
        eng = out["engine"]
        buffers = 3 if topk else 2
        per_wire = 20 * flat_wire_bytes(eng.layout, 1, 512, topk)
        if (eng.collectives != SHARDED_ROUNDS * wires * buffers
                or eng.collective_bytes != SHARDED_ROUNDS * wires * per_wire
                or out["wire_bytes"] != SHARDED_WIRE[(topk, algorithm)]):
            raise AssertionError(
                f"{label}: {eng.collectives} all-gathers of {eng.collective_bytes} B, "
                f"wire {out['wire_bytes']} B/round")
        card_w, card_comm = program_w_offs(eng, SHARDED_ROUNDS)
        cpu_w = cpu[label]["w"]
        run_comm = out["state"].comm
        same_counters = all(torch.equal(run_comm[k], card_comm[k])
                            for k in ("topo_round", "topo_up") if k in card_comm)
        if not torch.equal(card_w.view(torch.int32), cpu_w.view(torch.int32)) or not (
                same_counters):
            raise AssertionError(f"{label}: W_off not the CPU's ({same_counters})")
        if "node_program" in axes and axes["node_program"].startswith("slow_uplink"):
            losses, want_eff = cpu[label]["losses"], cpu[label]["effective"]
            eff = float(out["metrics"]["wire_bytes_effective"])
            if eff != want_eff or not eff < out["wire_bytes"]:
                raise AssertionError(f"{label}: effective bytes {eff} vs {want_eff}")
            note = (f"wire_bytes_effective {eff:,.0f} of {out['wire_bytes']:,.0f} B "
                    "(= the CPU's); vs the same run on the CPU")
        else:
            _, losses, _ = fused_oracle(algorithm, schedule, topk, **axes)
            note = "vs the fused engine on the card"
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], losses))
        if not all(math.isfinite(v) for v in out["losses"]) or rel > 1e-3:
            raise AssertionError(f"{label}: loss rel {rel}: {out['losses']} vs {losses}")
        fracs = ", ".join(f"{k} {float(v):.4f}" for k, v in out["metrics"].items()
                          if k.endswith("_fraction"))
        log(f"  {label}, {SHARDED_ROUNDS} rounds x Q=10 ({run_s:.2f} s): {SHARDED_ROUNDS} "
            f"{kernel} launches, {eng.collectives} all-gathers of "
            f"{eng.collective_bytes // SHARDED_ROUNDS:,} B a round (the static run's), "
            f"{eng.wire_encoding} wire; W_off of every round bitwise the CPU's; {fracs}; "
            f"{note}: loss rel {rel:.2e}")
    return launches


def privacy_fused_path(cpu: dict) -> dict:
    """(i) The fused engine under ``dp:sigma=0.5,clip=1.0``, 5 rounds at
    Q = 10: FD-DSGT through ``run_fused_engine``, FD-DSGD through the
    library's entry points; one round-kernel launch a round; the losses
    within 1e-3 relative of the same run on the CPU twins; ``dp_epsilon``
    the analytic bound within fp32 rounding; ``secure_agg`` added, the
    run bitwise its unmasked twin (``cpu``: :func:`phase3_host`'s)."""
    rounds, launches = SHARDED_ROUNDS, {}
    for algorithm, kernel in (("dsgt", "fused_round_gt"), ("dsgd", "fused_round")):
        runs = {}
        for spec in (DP_SPEC, "secure_agg+" + DP_SPEC):
            zero_counts()
            if algorithm == "dsgt":
                out = run_fused_engine(rounds=rounds, q=10, privacy=spec, device="cuda")
                runs[spec] = (out["losses"], out["params"], out["dp_epsilon"])
            else:
                state, losses, m = fused_oracle("dsgd", "sequential", None, rounds,
                                                privacy=spec)
                runs[spec] = (losses, {"flat": state.params}, float(m["dp_epsilon"]))
            expect_launches(f"fused {algorithm.upper()} {spec}", **{kernel: rounds})
            launches[kernel] = launches.get(kernel, 0) + rounds
        cpu_losses = cpu[("(i)", algorithm)]
        losses, params, eps = runs[DP_SPEC]
        m_losses, m_params, m_eps = runs["secure_agg+" + DP_SPEC]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
        want_eps = analytic_epsilon(0.5, rounds * (2 if algorithm == "dsgt" else 1), 1e-5)
        masked_same = losses == m_losses and eps == m_eps and all(
            torch.equal(a[1], b[1]) for a, b in zip(tree_leaves(params),
                                                    tree_leaves(m_params)))
        if (rel > 1e-3 or not all(math.isfinite(v) for v in losses)
                or abs(eps - want_eps) > 2e-6 * want_eps or not masked_same):
            raise AssertionError(
                f"fused {algorithm} dp: loss rel {rel}, epsilon {eps} vs {want_eps}, "
                f"secure_agg bitwise {masked_same}")
        log(f"  fused FD-{algorithm.upper()} {DP_SPEC}, {rounds} rounds x Q=10: {rounds} "
            f"{kernel} launches per run; loss {losses[0]:.4f} -> {losses[-1]:.4f}, max rel "
            f"diff to the CPU {rel:.2e}; dp_epsilon {eps:.6f} (analytic {want_eps:.6f}); "
            f"with secure_agg bitwise the unmasked run")
    return launches


def privacy_driver_path() -> dict:
    """(j) The privacy driver uncut (6 rows x 6 rounds at Q = 10, the
    committed experiments/privacy_ehr.json's budget) on the card: 36
    ``fused_round_gt`` launches; every row's wire bytes 167,184; the DP
    rows' ``epsilon`` (fp32) within 1e-6 relative of the JSON's and
    ``epsilon_rdp`` (float64) within 1e-12 of it; bal_acc printed beside the JSON's
    (another init); the driver asserts the secure_agg rows bitwise."""
    t0 = time.perf_counter()
    zero_counts()
    rec = privacy_ehr.run(privacy_ehr.SMOKE_ROUNDS, 10, device="cuda", log=False)
    rounds = len(rec["rows"]) * privacy_ehr.SMOKE_ROUNDS
    expect_launches("privacy driver", fused_round_gt=rounds)
    with open(os.path.join(ROOT, "experiments", "privacy_ehr.json")) as f:
        json_rows = {r["name"]: r for r in json.load(f)["rows"]}
    for row in rec["rows"]:
        ref = json_rows[row["name"]]
        bad = row["wire_bytes_per_round"] != WIRE_DSGT or row["iterations"] != ref["iterations"]
        if "epsilon" in ref:
            bad |= (abs(row["epsilon"] - ref["epsilon"]) > 1e-6 * ref["epsilon"]
                    or abs(row["epsilon_rdp"] - ref["epsilon_rdp"]) > 1e-12 * ref["epsilon_rdp"])
        if bad or not math.isfinite(row["bal_acc"]):
            raise AssertionError(f"privacy driver row {row} vs the JSON's {ref}")
        eps = (f", epsilon {row['epsilon']:.4f} / RDP {row['epsilon_rdp']:.4f} (= JSON)"
               if "epsilon" in row else "")
        log(f"  privacy {row['name']:24s}: wire {row['wire_bytes_per_round']:,.0f} B/round"
            f"{eps}, bal_acc {row['bal_acc']:.4f} (JSON {ref['bal_acc']:.4f})")
    log(f"  the privacy driver in {time.perf_counter() - t0:.1f} s: {rounds} fused_round_gt "
        "launches")
    return {"fused_round_gt": rounds}


def sharded_dp_path(group) -> dict:
    """(k) The sharded dense int8 wire under dp on the one-rank NCCL group
    (the rank draws its rows of the noise): after one round params and
    tracker within 1e-5 of the fused engine on the card, one wire-stage
    launch."""
    launches = {}
    for algorithm, kernel in (("dsgd", "wire_stage"), ("dsgt", "wire_stage_gt")):
        zero_counts()
        one = run_sharded_engine(group, rounds=1, q=10, algorithm=algorithm,
                                 privacy=DP_SPEC, log=False)
        expect_launches(f"sharded {algorithm} dp", **{kernel: 1})
        launches[kernel] = 1
        want, _, m = fused_oracle(algorithm, "sequential", None, rounds=1, privacy=DP_SPEC)
        st = one["state"]
        diff = float((st.params - want.params).abs().max())
        if algorithm == "dsgt":
            diff = max(diff, float((st.tracker - want.tracker).abs().max()))
        if diff > 1e-5 or float(one["metrics"]["dp_epsilon"]) != float(m["dp_epsilon"]):
            raise AssertionError(f"sharded {algorithm} dp vs the fused engine: {diff}")
        log(f"  sharded FD-{algorithm.upper()} {DP_SPEC}, dense int8 wire, one round: one "
            f"{kernel} launch, params/tracker within {diff:.2e} of the fused engine")
    return launches


def check_dp_epilogue() -> None:
    """Each DP wrapper on the card at the main shape (20, 1536), chunk
    512, dense and top-64 (and the compact wires at top-16 positions and
    top-64 bitmap), clip 1.0, noise of std 0.5: its launch against the
    twin fed the same substituted residual (the substitution is the
    wrapper's own PyTorch arithmetic on the card) -- every output bitwise
    but the round kernels' mixed (1e-5 x max(1, max|input|)); and the
    int8 payload against the twin with the direct epilogue (clip and
    noise, then quantize), which an ulp of float association may move
    across a rounding boundary: counted and printed."""
    n, t, chunk = 20, 1536, 512
    w_off, w_self = weights("hospital20", n)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [("fused_round", 1, None, {}), ("fused_round", 1, 64, {}),
             ("fused_round_gt", 2, None, {}), ("fused_round_gt", 2, 64, {}),
             ("wire_stage", 1, None, {}), ("wire_stage_gt", 2, 64, {}),
             ("wire_stage_compact", 1, 16, {"bitmap": False}),
             ("wire_stage_gt_compact", 2, 64, {"bitmap": True})]
    flips = 0
    for name, wires, topk, extra in cases:
        kernel, twin = {**KERNELS, **WIRE_KERNELS, **COMPACT_KERNELS}[name][:2]
        bufs = make_inputs(n, t, chunk, wires, "main", seed=11)
        noises = [0.5 * torch.randn(n, t, generator=gen, device="cuda") for _ in range(wires)]
        weights_ = (w_off, w_self) if name in KERNELS else ()
        kw = dict(scale_chunk=chunk, topk=topk, **extra)
        dp = dict(dp_clip=1.0, dp_noise=noises[0])
        if wires == 2:
            dp["dp_noise_t"] = noises[1]
        got = kernel(*bufs, *weights_, ALPHA, **kw, **dp)
        if wires == 1:
            x, g, recon, res = bufs
            sub, corr = gossip_wrappers._dp_dsgd(x, g, recon, res, ALPHA, True, 1.0,
                                                 noises[0])
            plain = list(twin(x, g, recon, sub, *weights_, ALPHA, **kw))
            res_i = [2] if name in KERNELS else [len(plain) - 1]
            corrs = [corr]
        else:
            x, tt, g, gp, rx, sx, rt, st = bufs
            subx, subt, cx, ct = gossip_wrappers._dp_dsgt(*bufs, ALPHA, True, 1.0, *noises)
            plain = list(twin(x, tt, g, gp, rx, subx, rt, subt, *weights_, ALPHA, **kw))
            res_i = ([3, 5] if name in KERNELS else
                     [5, 9] if name == "wire_stage_gt" else [6, 11])
            corrs = [cx, ct]
        for i, c in zip(res_i, corrs):
            plain[i] = plain[i] + c
        direct = twin(*bufs, *weights_, ALPHA, **kw, **dp)
        torch.cuda.synchronize()
        for i, (a_, b_) in enumerate(zip(got, plain)):
            mixed = name in KERNELS and i < wires
            if mixed:
                tol = 1e-5 * max(1.0, max(float(v.abs().max()) for v in bufs))
                ok = float((a_ - b_).abs().max()) <= tol
            else:
                ok = torch.equal(a_, b_)
            if not ok:
                raise AssertionError(f"{name} dp top-{topk}: output {i} differs from the twin")
        q_idx = [i for i, v in enumerate(got) if v.dtype == torch.int8]
        flips += sum(int((got[i] != direct[i]).sum()) for i in q_idx)
        del got, plain, direct, bufs, noises
    log(f"  the DP epilogue on every wrapper ({len(cases)} cases at 20x1536): each launch "
        f"== its twin on the substituted residual (bitwise but the mix); int8 entries "
        f"moved against the direct epilogue's: {flips}")
    torch.cuda.empty_cache()


def node_inits(device) -> dict:
    """Twenty distinct MLP inits, ``mlp_init(i)`` for hospital i, drawn on
    the CPU and moved to ``device``: the private heads differ between
    hospitals, and the card and the CPU start alike."""
    inits = [mlp_init(i, device="cpu") for i in range(20)]
    return tree_map(lambda *leaves: torch.stack(leaves).to(device), *inits)


def zero_loss(p, batch):
    """A loss whose gradient is exactly zero (every leaf times 0)."""
    return sum(0.0 * leaf.sum(dim=tuple(range(1, leaf.ndim))) for _, leaf in tree_leaves(p))


def scope_batches(rounds: int) -> list:
    """``rounds`` rounds of Q = 10 batches of the hardened cohort (the
    personalization driver's), m = 20."""
    batcher = make_node_batcher(generate_ehr_cohort(seed=0, **personalization_ehr.COHORT),
                                m=20, seed=1)
    return [stack_batches(batcher, 10) for _ in range(rounds)]


def scoped_build(device: str, algorithm: str, schedule: str, scope, privacy=None,
                 zero: bool = False):
    """FD-DSGD or FD-DSGT on the fused engine under ``scope`` through the
    library's entry points, at the personalization driver's chunk and
    alpha (0.01/sqrt(r)), the twenty distinct inits; returns (engine,
    round_fn, initial state)."""
    cfg = FLConfig(algorithm=algorithm, q=10, n_nodes=20)
    engine, flat = FusedEngine.simulated(
        mixing_matrix("hospital20", 20), node_inits(device), scale_chunk=SCOPE_CHUNK,
        round_schedule=schedule, privacy=privacy, scope=scope)
    loss = zero_loss if zero else make_mlp_loss(class_weights())
    return engine, make_fl_round(loss, inv_sqrt(0.01), cfg, engine), init_fl_state(cfg, flat,
                                                                                 engine)


def scoped_run(device: str, algorithm: str, schedule: str, scope, rounds: int = SCOPE_ROUNDS,
               privacy=None, zero: bool = False):
    """:func:`scoped_build`, then ``rounds`` rounds. Returns (engine, the
    initial flat buffer, each round's state, the losses, the last
    metrics)."""
    engine, round_fn, state = scoped_build(device, algorithm, schedule, scope, privacy, zero)
    start, states, losses = state.params.clone(), [], []
    for batches in scope_batches(rounds):
        state, m = round_fn(state, batches)
        states.append(state)
        losses.append(float(m["loss"]))
    return engine, start, states, losses, m


def _rel(what: str, got, want, tol: float) -> float:
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want))
    if not all(math.isfinite(v) for v in got) or rel > tol:
        raise AssertionError(f"{what}: losses {got} vs the CPU's {want} (rel {rel} > {tol})")
    return rel


def _private_untouched(what: str, engine, start, state) -> None:
    """The private columns bitwise their per-node inits (the tracker's
    zero) under a zero gradient; the shared columns mixed."""
    for a, b in engine.scope.private_ranges(engine.layout):
        if not torch.equal(state.params[:, a:b], start[:, a:b]):
            raise AssertionError(f"{what}: private columns [{a}, {b}) moved")
        if state.tracker is not None and bool(state.tracker[:, a:b].any()):
            raise AssertionError(f"{what}: the tracker's private columns [{a}, {b}) moved")
    if all(torch.equal(state.params[:, a:b], start[:, a:b])
           for a, b in engine.scope.shared_ranges(engine.layout)):
        raise AssertionError(f"{what}: the shared columns never mixed")


def scope_paths(group, cpu: dict) -> dict:
    """The federation scope on the card. (s1) The personalization driver
    uncut (3 cells x 150 rounds at Q = 10, chunk 128): 450
    ``fused_round_gt`` launches, the bytes exactly the JSON's, each
    cell's mean per-hospital balanced accuracy within
    PERSONALIZATION_BAL_TOL of the same driver on the card machine's CPU
    from the same init (the JSON's came from jax's init; printed
    beside). (s2) The backbone scope on fused FD-DSGD and FD-DSGT,
    sequential, pipelined, k = 2 and under dp, 5 rounds each: one round
    kernel (or wire stage at k = 2) a round; with a zero-gradient loss
    the private columns bitwise their per-node inits (the tracker's at
    zero); with the EHR loss the losses within SCOPE_LOSS_RTOL of the
    CPU twins and the scoped wire's bytes. (s3) ``layerwise:freq=4``:
    the head bitwise its init through the three rounds that do not
    fire, mixed on the fourth; the EHR losses against the CPU, the full
    wire's bytes. (s4) ``sharded_fused`` on the one-rank NCCL group
    under the backbone scope, dense int8 and top-16: one wire-stage
    launch a round, the scoped wire's all-gathers and bytes, the losses
    within rtol 1e-3 of the fused engine, the dense wire's params within
    1e-5 after one round. The CPU runs of (s1)-(s3) are
    :func:`phase3_host`'s (``cpu``)."""
    launches = {}

    def count(kernel, n):
        launches[kernel] = launches.get(kernel, 0) + n

    t0 = time.perf_counter()
    init = mlp_init(0, device="cpu")
    zero_counts()
    rec = personalization_ehr.run(PERSONALIZATION_ROUNDS, 10, device="cuda", init_params=init,
                                  log=False)
    rounds = len(rec["rows"]) * PERSONALIZATION_ROUNDS
    expect_launches("(s1) personalization driver", fused_round_gt=rounds)
    count("fused_round_gt", rounds)
    card_s = time.perf_counter() - t0
    with open(os.path.join(ROOT, "experiments", "personalization_ehr.json")) as f:
        json_rows = {r["name"]: r for r in json.load(f)["rows"]}
    for row, c in zip(rec["rows"], cpu["(s1)"]):
        ref = json_rows[row["name"]]
        gap = abs(row["bal_acc_per_hospital_mean"] - c["bal_acc_per_hospital_mean"])
        if (row["wire_bytes_per_round"] != PERSONALIZATION_WIRE[row["name"]]
                or row["wire_bytes_per_round"] != ref["wire_bytes_per_round"]
                or gap > PERSONALIZATION_BAL_TOL):
            raise AssertionError(f"(s1) {row['name']}: {row} vs the CPU's {c}")
        log(f"  (s1) personalization {row['name']:16s}: wire {row['wire_bytes_per_round']:,.0f} "
            f"B/round (= JSON), {row['wire_total_cols']}/{row['layout_total_cols']} wire "
            f"columns, per-hospital bal_acc {row['bal_acc_per_hospital_mean']:.4f} (CPU "
            f"{c['bal_acc_per_hospital_mean']:.4f}, JSON {ref['bal_acc_per_hospital_mean']:.4f} "
            f"from jax's init), consensus {row['bal_acc_consensus_per_hospital_mean']:.4f}")
    log(f"  (s1) the driver uncut: {rounds} fused_round_gt launches in {card_s:.1f} s on the "
        f"card (chunk {SCOPE_CHUNK}, clusters of {fused_plan('fused_round_gt', 20, 1408, 128, None)[0]} "
        f"on the backbone wire, {fused_plan('fused_round_gt', 20, 1536, 128, None)[0]} on the "
        "full one)")

    kernels = {("dsgd", False): "fused_round", ("dsgt", False): "fused_round_gt",
               ("dsgd", True): "wire_stage", ("dsgt", True): "wire_stage_gt"}
    for algorithm in ("dsgd", "dsgt"):
        for schedule, privacy in SCOPE_RUNS:
            kernel = kernels[(algorithm, schedule.startswith("bounded"))]
            label = (f"(s2) fused FD-{algorithm.upper()} backbone {schedule}"
                     + (f" {privacy}" if privacy else ""))
            zero_counts()
            eng, start, states, _, _ = scoped_run("cuda", algorithm, schedule, "backbone",
                                                  privacy=privacy, zero=True)
            expect_launches(label + ", zero gradient", **{kernel: SCOPE_ROUNDS})
            _private_untouched(label, eng, start, states[-1])
            zero_counts()
            eng, _, _, losses, m = scoped_run("cuda", algorithm, schedule, "backbone",
                                              privacy=privacy)
            expect_launches(label, **{kernel: SCOPE_ROUNDS})
            count(kernel, 2 * SCOPE_ROUNDS)
            cpu_losses = cpu[("(s2)", algorithm, schedule, privacy)]
            rel = _rel(label, losses, cpu_losses, SCOPE_LOSS_RTOL)
            if m["wire_bytes"] != SCOPE_WIRE[(None, algorithm)]:
                raise AssertionError(f"{label}: wire {m['wire_bytes']}")
            log(f"  {label}, {SCOPE_ROUNDS} rounds x Q=10 twice: {2 * SCOPE_ROUNDS} {kernel} "
                f"launches; zero gradient: the private columns bitwise their inits; EHR loss "
                f"{losses[0]:.4f} -> {losses[-1]:.4f}, max rel diff to the CPU {rel:.2e}, wire "
                f"{m['wire_bytes']:,.0f} B/round")

    label = "(s3) fused FD-DSGT layerwise:freq=4"
    zero_counts()
    eng, start, states, _, _ = scoped_run("cuda", "dsgt", "sequential", "layerwise:freq=4",
                                          rounds=4, zero=True)
    expect_launches(label + ", zero gradient", fused_round_gt=4)
    gated = eng.scope.gate_ranges(eng.layout)
    for rnd, st in enumerate(states, 1):
        still = all(torch.equal(st.params[:, a:b], start[:, a:b]) for a, b in gated)
        if still != (rnd < 4):
            raise AssertionError(f"{label}: head unchanged after round {rnd}: {still}")
    zero_counts()
    _, _, _, losses, m = scoped_run("cuda", "dsgt", "sequential", "layerwise:freq=4", rounds=8)
    expect_launches(label, fused_round_gt=8)
    count("fused_round_gt", 12)
    rel = _rel(label, losses, cpu["(s3)"], SCOPE_LOSS_RTOL)
    if m["wire_bytes"] != PERSONALIZATION_WIRE["layerwise_freq4"]:
        raise AssertionError(f"{label}: wire {m['wire_bytes']}")
    log(f"  {label}: 4 + 8 fused_round_gt launches; zero gradient: the head bitwise its init "
        f"through rounds 1-3, mixed at round 4; EHR loss max rel diff to the CPU {rel:.2e} over "
        f"8 rounds; the full wire, {m['wire_bytes']:,.0f} B/round")

    for algorithm in ("dsgd", "dsgt"):
        wires = 2 if algorithm == "dsgt" else 1
        for topk in (None, 16):
            kernel = {(True, 1): "wire_stage_compact", (True, 2): "wire_stage_gt_compact",
                      (False, 1): "wire_stage", (False, 2): "wire_stage_gt"}[(topk is not None,
                                                                              wires)]
            label = (f"(s4) sharded FD-{algorithm.upper()} backbone "
                     + (f"top-{topk}" if topk else "int8"))
            zero_counts()
            out = run_sharded_engine(group, rounds=SHARDED_ROUNDS, q=10, algorithm=algorithm,
                                     topk=topk, scale_chunk=SCOPE_CHUNK, scope="backbone",
                                     log=False)
            expect_launches(label, **{kernel: SHARDED_ROUNDS})
            count(kernel, SHARDED_ROUNDS)
            eng = out["engine"]
            buffers = 3 if topk else 2
            per_wire = 20 * flat_wire_bytes(eng.wire_layout, 1, SCOPE_CHUNK, topk)
            if (eng.wire_layout.total != 1408
                    or eng.collectives != SHARDED_ROUNDS * wires * buffers
                    or eng.collective_bytes != SHARDED_ROUNDS * wires * per_wire
                    or out["wire_bytes"] != SCOPE_WIRE[(topk, algorithm)]):
                raise AssertionError(
                    f"{label}: {eng.collectives} all-gathers of {eng.collective_bytes} B, "
                    f"wire {out['wire_bytes']} B/round")
            state, losses, _ = fused_oracle(algorithm, "sequential", topk,
                                            scale_chunk=SCOPE_CHUNK, scope="backbone")
            rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], losses))
            if not all(math.isfinite(v) for v in out["losses"]) or rel > 1e-3:
                raise AssertionError(f"{label}: loss rel {rel}: {out['losses']} vs {losses}")
            note = ""
            if topk is None:
                zero_counts()
                one = run_sharded_engine(group, rounds=1, q=10, algorithm=algorithm,
                                         scale_chunk=SCOPE_CHUNK, scope="backbone",
                                         log=False)["state"]
                expect_launches(label + ", one round", **{kernel: 1})
                want = fused_oracle(algorithm, "sequential", None, rounds=1,
                                    scale_chunk=SCOPE_CHUNK, scope="backbone")[0]
                diff1 = float((one.params - want.params).abs().max())
                if algorithm == "dsgt":
                    diff1 = max(diff1, float((one.tracker - want.tracker).abs().max()))
                if diff1 > 1e-5:
                    raise AssertionError(f"{label}: one round off the fused engine by {diff1}")
                count(kernel, 1)
                note = f", params/tracker within {diff1:.2e} after one round"
            log(f"  {label}, {SHARDED_ROUNDS} rounds x Q=10: {SHARDED_ROUNDS} {kernel} "
                f"launches, {eng.collectives} all-gathers of "
                f"{eng.collective_bytes // SHARDED_ROUNDS:,} B a round ({eng.wire_encoding} "
                f"wire on {eng.wire_layout.total} columns), {out['wire_bytes']:,.0f} B/round; "
                f"vs the fused engine: loss rel {rel:.2e}{note}")
    return launches


def checkpoint_paths(group) -> dict:
    """Checkpoints on the card: a scoped (backbone) FD-DSGT k = 2 run saved
    at round 3, restored onto a fresh engine and run 3 more rounds equals
    the uninterrupted 6-round run bitwise (params, tracker, every comm
    buffer); a fused FD-DSGT checkpoint restored onto ``sharded_fused`` on
    the one-rank NCCL group rebuilds ``mix_recon`` (W_off @ recon, within
    1e-6) and resumes on the multi-round policy (one round within 1e-5 of
    the fused engine, the second's loss within rtol 1e-3); a restore
    under another scope is refused."""
    d = tempfile.mkdtemp()
    try:
        batches = scope_batches(6)
        eng, rf, st0 = scoped_build("cuda", "dsgt", "bounded_staleness:k=2", "backbone")
        zero_counts()
        whole = st0
        for b in batches:
            whole, _ = rf(whole, b)
        half = st0
        for b in batches[:3]:
            half, _ = rf(half, b)
        save_fl_state(os.path.join(d, "k2"), half, engine=eng)
        eng2, rf2, tmpl = scoped_build("cuda", "dsgt", "bounded_staleness:k=2", "backbone")
        back = load_fl_state(os.path.join(d, "k2"), tmpl, engine=eng2)
        for b in batches[3:]:
            back, _ = rf2(back, b)
        expect_launches("checkpointed FD-DSGT k=2", wire_stage_gt=12)
        same = [k for k in ("params", "tracker", "prev_grad")
                if torch.equal(getattr(back, k), getattr(whole, k))]
        same += [k for k in whole.comm if torch.equal(back.comm[k], whole.comm[k])]
        if len(same) != 3 + len(whole.comm) or back.step != whole.step:
            raise AssertionError(f"resumed run not bitwise the uninterrupted one: equal {same}")
        log(f"  checkpoint of a backbone FD-DSGT k=2 run at round 3, restored, 3 more rounds: "
            f"bitwise the uninterrupted 6-round run (params, tracker, prev_grad and "
            f"{len(whole.comm)} comm buffers); 12 wire_stage_gt launches")

        eng, rf, st = scoped_build("cuda", "dsgt", "sequential", "backbone")
        zero_counts()
        for b in batches[:3]:
            st, _ = rf(st, b)
        save_fl_state(os.path.join(d, "fused"), st, engine=eng)
        cfg = FLConfig(algorithm="dsgt", q=10, n_nodes=20)
        sh, rows = ShardedFusedEngine.from_group(
            group, node_inits("cuda"), w=mixing_matrix("hospital20", 20),
            scale_chunk=SCOPE_CHUNK, scope="backbone")
        sh_rf = make_fl_round(make_mlp_loss(class_weights()), inv_sqrt(0.01), cfg, sh)
        back = load_fl_state(os.path.join(d, "fused"), init_fl_state(cfg, rows, sh), engine=sh)
        rebuilt = max(float((back.comm["mix_recon" + s] - sh.w_off @ st.comm["recon" + s])
                            .abs().max()) for s in ("", "_t"))
        diffs, rels = [], []
        for b in batches[3:5]:
            st, m = rf(st, b)
            back, m_sh = sh_rf(back, b)
            diffs.append(max(float((back.params - st.params).abs().max()),
                             float((back.tracker - st.tracker).abs().max())))
            rels.append(abs(float(m_sh["loss"]) - float(m["loss"])) / abs(float(m["loss"])))
        expect_launches("fused checkpoint onto sharded_fused", fused_round_gt=5,
                        wire_stage_gt=2)
        # the multi-round policy: one round within 1e-5, then the loss
        # within rtol 1e-3 (an ulp of mix_recon can move an int8 step)
        if rebuilt > 1e-6 or diffs[0] > 1e-5 or max(rels) > 1e-3:
            raise AssertionError(f"fused -> sharded restore: mix_recon off by {rebuilt}, "
                                 f"params/tracker by {diffs}, loss rel {rels}")
        log(f"  a fused backbone FD-DSGT checkpoint (round 3) onto sharded_fused: mix_recon "
            f"rebuilt within {rebuilt:.2e} of W_off @ recon; one round later params/tracker "
            f"within {diffs[0]:.2e} of the fused engine, two rounds later {diffs[1]:.2e} "
            f"(loss rel {max(rels):.2e})")

        other, _, tmpl = scoped_build("cuda", "dsgt", "sequential", None)
        try:
            load_fl_state(os.path.join(d, "fused"), tmpl, engine=other)
        except ValueError as e:
            if "federation scope 'backbone'" not in str(e):
                raise
            log("  the backbone checkpoint onto a full-scope engine: refused "
                f"({str(e)[:72]}...)")
        else:
            raise AssertionError("a restore under another scope was not refused")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {"wire_stage_gt": 14, "fused_round_gt": 5}


def snapshot_serving_path() -> dict:
    """Snapshots on the card. The backbone run's snapshot (5 FD-DSGT
    rounds): the consensus row the card's node mean, ``node=i`` each
    hospital's private columns bitwise its row's. SmolLM-360M at full
    width and depth (seeded random weights) written as a one-row
    consensus snapshot (1.45 GB of fp32), mapped by ``load_snapshot``
    and served by ``ServeEngine.from_snapshot`` (staged onto the card):
    32 greedy tokens equal to the in-memory engine's on the same weights;
    then a second snapshot published by ``publish_snapshot`` after decode
    step SNAPSHOT_SWAP_AT lands at that step boundary, and the tokens
    equal an in-memory engine's that swaps the same weights at the same
    step; the swap's pause recorded."""
    d = tempfile.mkdtemp()
    launches = {}
    try:
        zero_counts()
        eng, _, states, _, _ = scoped_run("cuda", "dsgt", "sequential", "backbone")
        expect_launches("backbone snapshot run", fused_round_gt=SCOPE_ROUNDS)
        launches["fused_round_gt"] = SCOPE_ROUNDS
        params = states[-1].params
        write_snapshot(os.path.join(d, "ehr"), params, eng.layout, round_frontier=SCOPE_ROUNDS,
                       engine=eng)
        cons = load_snapshot(os.path.join(d, "ehr"), verify=True).flat
        host = params.cpu()
        if not torch.equal(cons, params.mean(dim=0).cpu()):
            raise AssertionError("the snapshot's consensus is not the node mean")
        private = eng.scope.private_ranges(eng.layout)
        for i in range(20):
            pers = load_snapshot(os.path.join(d, "ehr"), node=i).flat
            if not all(torch.equal(pers[a:b], host[i, a:b]) for a, b in private) or not all(
                    torch.equal(pers[a:b], cons[a:b])
                    for a, b in eng.scope.shared_ranges(eng.layout)):
                raise AssertionError(f"node={i}: the overlay is not hospital {i}'s head")
        log(f"  the backbone run's snapshot: consensus = the card's node mean bitwise; node=i "
            f"overlays hospital i's private columns {list(private)} bitwise, all 20")

        cfg = get_config(SERVE_ARCH)
        bundle = build_model(cfg)
        weights = [bundle.init_fn(torch.Generator(device="cuda").manual_seed(s), device="cuda")
                   for s in (0, 1)]
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=(SERVE_BATCH, SNAPSHOT_PROMPT)).astype(np.int32)
        sdir = os.path.join(d, "smollm")
        write_s = []
        for rnd, w in enumerate(weights, 1):
            flat, layout = pack(tree_map(lambda p: p[None], w))
            t0 = time.perf_counter()
            header = write_snapshot(sdir, flat, layout, round_frontier=rnd)
            write_s.append(time.perf_counter() - t0)
            del flat
        with open(header) as f:
            blob_bytes = json.load(f)["blob_bytes"]
        t0 = time.perf_counter()
        snaps = [load_snapshot(sdir, rnd, template=weights[0]) for rnd in (1, 2)]
        map_ms = (time.perf_counter() - t0) * 1e3 / 2
        steps = SNAPSHOT_PROMPT + SNAPSHOT_NEW - 1
        n_decode = cfg.n_layers * steps

        def generate(engine, swap=None):
            """Greedy tokens; ``swap(engine)`` publishes after decode step
            SNAPSHOT_SWAP_AT."""
            if swap is not None:
                step, calls = engine.decode_step, {"n": 0}

                def publishing_step(tokens, caches):
                    out = step(tokens, caches)
                    calls["n"] += 1
                    if calls["n"] == SNAPSHOT_SWAP_AT:
                        swap(engine)
                    return out

                engine.decode_step = publishing_step
            zero_counts()
            out = engine.generate(prompts, max_new_tokens=SNAPSHOT_NEW, temperature=0.0)
            expect_launches("snapshot serving generate", decode_attention=n_decode)
            launches["decode_attention"] = launches.get("decode_attention", 0) + n_decode
            return out

        kw = dict(max_seq=SERVE_MAX_SEQ, batch=SERVE_BATCH)
        want = generate(ServeEngine(bundle, weights[0], snapshot_round=1, **kw)).tokens
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = ServeEngine.from_snapshot(bundle, snaps[0], stage=True, **kw)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        if not all(leaf.device.type == "cuda" for _, leaf in tree_leaves(served.params)):
            raise AssertionError("from_snapshot(stage=True) left a leaf off the card")
        got = generate(served).tokens
        if not np.array_equal(got, want):
            raise AssertionError("tokens served from the snapshot differ from the in-memory "
                                 "engine's")
        swapped = generate(ServeEngine(bundle, weights[0], snapshot_round=1, **kw),
                           swap=lambda e: e.publish(weights[1], 2)).tokens
        hot = ServeEngine.from_snapshot(bundle, snaps[0], stage=True, **kw)
        out = generate(hot, swap=lambda e: e.publish_snapshot(snaps[1]))
        if (out.swap_steps != (SNAPSHOT_SWAP_AT,) or hot.swap_count != 1
                or hot.snapshot_round != 2 or hot._active_ref is not snaps[1]
                or not np.array_equal(out.tokens, swapped)):
            raise AssertionError(f"snapshot hot swap: steps {out.swap_steps}, round "
                                 f"{hot.snapshot_round}, tokens equal "
                                 f"{np.array_equal(out.tokens, swapped)}")
        log(f"  {cfg.name} as a snapshot: {blob_bytes / 1e9:.3f} GB blobs written in "
            f"{write_s[0]:.2f} / {write_s[1]:.2f} s, mapped in {map_ms:.2f} ms, staged onto the "
            f"card in {stage_s:.2f} s; {SNAPSHOT_NEW} greedy tokens (batch {SERVE_BATCH}, "
            f"{SNAPSHOT_PROMPT}-token prompts) equal the in-memory engine's; publish_snapshot "
            f"after step {SNAPSHOT_SWAP_AT} landed at {out.swap_steps} "
            f"({hot.swap_pauses[0] * 1e6:.1f} us pause), tokens equal an in-memory swap's; "
            f"{4 * n_decode} decode_attention launches")
        del served, hot, snaps, weights
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return launches


def scope_timings(card: str) -> dict:
    """Whole FD-DSGT Q = 10 rounds at the personalization driver's chunk
    128: the full scope and the backbone scope (the gathered 1,408-column
    wire, the scatter back around the private columns), same call."""
    return {"chunk 128 full": round_profile(card, scale_chunk=SCOPE_CHUNK),
            "chunk 128 backbone": round_profile(card, scale_chunk=SCOPE_CHUNK,
                                                scope="backbone")}


def _logit_diff(what: str, got: torch.Tensor, want: torch.Tensor,
                tol: float = SERVE_LOGIT_TOL) -> float:
    """max |got - want| / max(1, max |want|), held to ``tol``."""
    got, want = got.float().cpu(), want.float().cpu()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: logits not finite")
    rel = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
    if rel > tol:
        raise AssertionError(f"{what}: logits off by {rel:.3e} of their scale")
    return rel


def _replay(bundle, params, tokens: torch.Tensor, steps: int, device,
            max_seq: int = SERVE_MAX_SEQ):
    """Step tokens[:, :steps] through the bundle's decode function on a
    fresh cache of ``max_seq`` slots; returns each step's logits."""
    caches = bundle.init_decode_state_fn(tokens.shape[0], max_seq, device=device)
    out = []
    for t in range(steps):
        logits, caches = bundle.decode_fn(params, tokens[:, t].to(device), caches)
        out.append(logits)
    return out


def serving_path() -> dict:
    """The serving path at SmolLM-360M's full width, through its entry
    points: ``ServeEngine.generate`` launches the decode kernel once per
    layer and step and never the flash kernel, and promotes a weight set
    published mid-run at the next step boundary; ``bundle.prefill_fn``
    launches the flash kernel once per layer; its last-position logits
    agree with the decode replay's, and the replay's first steps agree
    with the same model on the host CPU."""
    cfg = get_config(SERVE_ARCH)
    bundle = build_model(cfg)
    params = bundle.init_fn(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    params_b = bundle.init_fn(torch.Generator(device="cuda").manual_seed(1), device="cuda")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    engine = ServeEngine(bundle, params, max_seq=SERVE_MAX_SEQ, batch=SERVE_BATCH,
                         snapshot_round=0)
    step, calls = engine.decode_step, {"n": 0}

    def publishing_step(tokens, caches):
        out = step(tokens, caches)
        calls["n"] += 1
        if calls["n"] == SWAP_AFTER:  # published from outside, between steps
            engine.publish(params_b, snapshot_round=1)
        return out

    engine.decode_step = publishing_step
    log(f"  {cfg.name}: {cfg.param_count():,} parameters (fp32), {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} q-heads over {cfg.n_kv_heads} kv-heads")
    steps = SERVE_PROMPT + SERVE_NEW - 1
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=SERVE_NEW, temperature=0.0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    del engine.decode_step  # the class's own step from here on
    expect_launches("serving generate", decode_attention=cfg.n_layers * steps)
    new = out.tokens[:, SERVE_PROMPT:]
    if (out.tokens.shape != (SERVE_BATCH, SERVE_PROMPT + SERVE_NEW)
            or not (out.tokens[:, :SERVE_PROMPT] == prompts).all()
            or new.min() < 0 or new.max() >= cfg.vocab_size):
        raise AssertionError(f"generate: tokens {out.tokens.shape}, new in "
                             f"[{new.min()}, {new.max()}]")
    if (out.swap_steps != (SWAP_AFTER,) or engine.swap_count != 1
            or engine.staleness(1) != 0):
        raise AssertionError(f"hot swap: swap_steps {out.swap_steps}, count "
                             f"{engine.swap_count}, staleness {engine.staleness(1)}")
    log(f"  generate (batch {SERVE_BATCH}, {SERVE_PROMPT} prompt + {SERVE_NEW} new tokens, "
        f"greedy): {cfg.n_layers * steps} decode_attention launches ({cfg.n_layers} layers "
        f"x {steps} steps), no flash_attention; swap published after step {SWAP_AFTER} "
        f"landed at {out.swap_steps} ({engine.swap_pauses[0] * 1e6:.1f} us pause); "
        f"{gen_s:.2f} s, {SERVE_BATCH * SERVE_NEW / gen_s:.1f} new tokens/s end to end; "
        f"row 0 continues {new[0, :8].tolist()}")

    tokens = torch.as_tensor(out.tokens, dtype=torch.long)
    zero_counts()
    pre, _ = bundle.prefill_fn(params, {"tokens": tokens[:, :SERVE_PROMPT].cuda()})
    expect_launches("serving prefill", flash_attention=cfg.n_layers)
    replay = _replay(bundle, params, tokens, SERVE_PROMPT, "cuda")
    rel = _logit_diff("prefill vs decode replay", pre, replay[-1])
    agree = int((pre.float().argmax(-1) == replay[-1].float().argmax(-1)).sum())
    log(f"  prefill_fn: {cfg.n_layers} flash_attention launches; last-position logits vs "
        f"the decode replay's at prompt token {SERVE_PROMPT}: max diff {rel:.3e} of their "
        f"scale (tolerance {SERVE_LOGIT_TOL}), argmax agrees on {agree}/{SERVE_BATCH} rows")

    t0 = time.perf_counter()
    cpu_params = tree_map(lambda a: a.cpu(), params)
    # the host's cache holds the CPU_STEPS slots the replay fills: the
    # card's 4096-slot cache masks the same empty slots out, and the host's
    # twin attention reads every slot, live or not
    cpu = _replay(bundle, cpu_params, tokens, CPU_STEPS, "cpu", max_seq=CPU_STEPS)
    worst = max(_logit_diff(f"card vs CPU step {t}", replay[t], cpu[t])
                for t in range(CPU_STEPS))
    log(f"  the card's tokens teacher-forced on the host CPU for {CPU_STEPS} steps "
        f"({time.perf_counter() - t0:.1f} s): per-step logits within {worst:.3e} of their "
        f"scale (tolerance {SERVE_LOGIT_TOL})")
    del cpu_params, cpu, replay
    # a 4096-slot cache is one split: expect_launches held the combine at 0
    return {"decode_attention": cfg.n_layers * steps, "flash_attention": cfg.n_layers,
            "decode_attention_combine": 0, "engine": engine, "prompts": prompts, "gen_s": gen_s}


def _argmax_agree(what: str, got: torch.Tensor, want: torch.Tensor) -> str:
    """The argmax of every row agrees wherever it is decided: where the
    reference row's top two logits are further apart than twice the
    row's largest difference (a closer pair is a tie at this precision)."""
    got, want = got.float().cpu(), want.float().cpu()
    top2 = want.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * (got - want).abs().max(dim=-1).values
    agree = got.argmax(-1) == want.argmax(-1)
    if not bool(agree[decided].all()):
        raise AssertionError(f"{what}: argmax differs on a decided row: agree "
                             f"{agree.tolist()}, decided {decided.tolist()}")
    return f"argmax agrees on {int(agree.sum())}/{len(agree)} rows ({int(decided.sum())} decided)"


def recurrent_serving_path(arch: str) -> dict:
    """One recurrent family's serving path at full width and depth,
    through its entry points (``get_config`` -> ``build_model`` ->
    ``init_fn`` from a seeded CUDA generator -> ``ServeEngine.generate``),
    counting each kernel's launches: every decode step launches the
    family's scan kernel once per recurrent layer (and RecurrentGemma the
    decode kernel once per local-attention layer); ``prefill_fn`` launches
    the scan once per recurrent layer (and flash once per attention
    layer), and its last-position logits agree with the decode replay's.
    Then, on a fresh model of the same width at reduced depth and fp32
    compute, prefill against the decode replay and the replay against the
    host CPU's (full-depth fp32 weights do not fit the host check)."""
    cfg = get_config(arch)
    kinds = cfg.effective_pattern
    n_rec = sum(k in ("rwkv", "recurrent") for k in kinds)
    n_attn = len(kinds) - n_rec
    scan = "wkv6" if arch.startswith("rwkv") else "rglru_scan"
    bundle = build_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init_fn(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.param_count():,} parameters (fp32, drawn in "
        f"{time.perf_counter() - t0:.1f} s), {cfg.n_layers} layers ({n_rec} {scan}, "
        f"{n_attn} local attention), d_model {cfg.d_model}, vocab {cfg.vocab_size:,}")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    engine = ServeEngine(bundle, params, max_seq=SERVE_MAX_SEQ, batch=SERVE_BATCH)
    steps = SERVE_PROMPT + REC_NEW - 1
    want = {scan: n_rec * steps}
    if n_attn:
        want["decode_attention"] = n_attn * steps
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=REC_NEW, temperature=0.0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    expect_launches(f"{arch} generate", **want)
    new = out.tokens[:, SERVE_PROMPT:]
    if (out.tokens.shape != (SERVE_BATCH, SERVE_PROMPT + REC_NEW)
            or not (out.tokens[:, :SERVE_PROMPT] == prompts).all()
            or new.min() < 0 or new.max() >= cfg.vocab_size):
        raise AssertionError(f"{arch} generate: tokens {out.tokens.shape}, new in "
                             f"[{new.min()}, {new.max()}]")
    log(f"  generate (batch {SERVE_BATCH}, {SERVE_PROMPT} prompt + {REC_NEW} new tokens, "
        f"greedy, {steps} steps): launches {want} (no flash_attention); {gen_s:.2f} s, "
        f"{SERVE_BATCH * REC_NEW / gen_s:.1f} new tokens/s end to end; row 0 continues "
        f"{new[0, :8].tolist()}")

    tokens = torch.as_tensor(out.tokens, dtype=torch.long)
    prompt = {"tokens": tokens[:, :SERVE_PROMPT].cuda()}
    pre_want = {scan: n_rec}
    if n_attn:
        pre_want["flash_attention"] = n_attn
    zero_counts()
    pre, _ = bundle.prefill_fn(params, prompt)
    expect_launches(f"{arch} prefill", **pre_want)
    replay = _replay(bundle, params, tokens, SERVE_PROMPT, "cuda")[-1]
    tol = REC_PREFILL_TOL[arch]
    rel = _logit_diff(f"{arch} prefill vs decode replay", pre, replay, tol)
    log(f"  prefill_fn: launches {pre_want}; last-position logits vs the decode replay's "
        f"at prompt token {SERVE_PROMPT}: max diff {rel:.3e} of their scale (tolerance "
        f"{tol}), {_argmax_agree(f'{arch} prefill vs replay', pre, replay)}")
    del engine, params, pre, replay
    torch.cuda.empty_cache()

    small = dataclasses.replace(cfg, n_layers=RECURRENT_ARCHS[arch], compute_dtype="float32")
    sbundle = build_model(small)
    sparams = sbundle.init_fn(torch.Generator(device="cuda").manual_seed(1), device="cuda")
    pre, _ = sbundle.prefill_fn(sparams, prompt)
    replay = _replay(sbundle, sparams, tokens, SERVE_PROMPT, "cuda")
    rel = _logit_diff(f"{arch} fp32 prefill vs decode replay", pre, replay[-1],
                      REC_FP32_PREFILL_TOL)
    log(f"  {small.n_layers} layers ({', '.join(small.effective_pattern)}) at full width, "
        f"fresh weights, fp32 compute: prefill vs the decode replay max diff {rel:.3e} of "
        f"their scale (tolerance {REC_FP32_PREFILL_TOL}), "
        f"{_argmax_agree(f'{arch} fp32 prefill', pre, replay[-1])}")
    t0 = time.perf_counter()
    card = replay[:REC_CPU_STEPS]
    cpu = _replay(sbundle, tree_map(lambda a: a.cpu(), sparams), tokens, REC_CPU_STEPS,
                  "cpu")
    worst = max(_logit_diff(f"{arch} card vs CPU step {t}", card[t], cpu[t],
                            REC_FP32_CPU_TOL) for t in range(REC_CPU_STEPS))
    log(f"  the same model, the card vs the host CPU over {REC_CPU_STEPS} "
        f"teacher-forced steps ({time.perf_counter() - t0:.1f} s): logits within "
        f"{worst:.3e} of their scale (tolerance {REC_FP32_CPU_TOL}); "
        f"{_argmax_agree(f'{arch} card vs CPU', card[-1], cpu[-1])} at the last step")
    del sparams, pre, replay, card, cpu
    torch.cuda.empty_cache()
    return want


# ---------------------------------------------------------------------------
# Training the transformer (t1)-(t4)
# ---------------------------------------------------------------------------

# (t1) the kernels' gradients on the card against autograd through their
# twins on the card, at the training paths' shapes: (label, B, S, H, K,
# hd, window) for flash -- SmolLM-360M's heads, RecurrentGemma-2B's MQA at
# head size 256 with its 2048-slot window (wider than S 128: no key falls
# out) and with a window of 32 that masks
FLASH_GRAD_SHAPES = [
    ("smollm-360m", 1, 128, 15, 5, 64, 0),
    ("recurrentgemma-2b", 1, 128, 10, 1, 256, 2048),
    ("recurrentgemma-2b window 32", 1, 128, 10, 1, 256, 32),
]
WKV_GRAD_SHAPE = ("rwkv6-7b", 1, 128, 64)  # B, S, H (d_model 4096)
LRU_GRAD_SHAPE = ("recurrentgemma-2b", 1, 128, 2560)  # B, S, W
# each gradient within tol x max(1e-30, max|twin's gradient|): fp32 1e-3
# (the same closed form fed by the kernel's output, which differs from the
# twin's by the forward's own tolerance), bf16 5e-2 (the forward's output
# and the gradients rounded to bf16) -- the serving phase's tolerances
GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
# (t1) full-width models at cut depth, n = 2 nodes, S 128: every leaf's
# gradient on the card against the host CPU's from the same params. The
# depths keep SmolLM's dense block, one RecurrentGemma period (recurrent,
# recurrent, local_attention) and one RWKV6 block; (arch, depth, dtypes).
# bf16 for SmolLM only: the host CPU's bf16 products are about twice as
# slow as its fp32 ones, RecurrentGemma's 256,000-row unembedding the
# costliest, and RWKV6's bf16 gradients are ill-conditioned past any
# tolerance (a head's first output is the rank-one bonus (r . (u * k)) v,
# which its RMS norm divides by; tests/test_torch_lm_loss.py)
GRAD_MODELS = [("smollm-360m", 2, ("float32", "bfloat16")),
               ("recurrentgemma-2b", 3, ("float32",)),
               ("rwkv6-7b", 1, ("float32",))]
GRAD_NODES, TRAIN_SEQ = 2, 128
# (t2) SmolLM-360M at full width and depth through train_decentralized:
# FD-DSGT Q = 2, batch 1, S 128, one round on the tree engine (4 nodes on
# a ring) and on the fused engine (int8 wire, chunk 512; 2 nodes: the
# round kernel's 14 (n, total) fp32 buffers take 40.5 GB at n = 2), then
# one more under the profiler; (b4) trains TRAIN_ROUNDS through the launcher
TRAIN_ARCH, TREE_NODES, FUSED_NODES, TRAIN_ROUNDS, TRAIN_Q = "smollm-360m", 4, 2, 3, 2
T2_ROUNDS = 1
TRAIN_ALPHA0 = 0.02
# round 1's local_loss, card against the host CPU from the same init: one
# bf16 model summed in another order (a full-depth training round takes
# the host CPU minutes, so it computes the init's forward only)
TRAIN_LOSS_RTOL = 1e-2


def _grad_err(what: str, got: torch.Tensor, want: torch.Tensor, tol: float,
              scale=None) -> float:
    """max|got - want| over max|want| (or over ``scale``); raises past
    ``tol``, on non-finite values and on an all-zero gradient."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max()) if scale is None else scale
    if not torch.isfinite(got).all() or got.shape != want.shape:
        raise AssertionError(f"{what}: gradient not finite or of shape {tuple(got.shape)}")
    if scale == 0.0 or float(got.abs().max()) == 0.0:
        raise AssertionError(f"{what}: an all-zero gradient (card max "
                             f"{float(got.abs().max())}, reference max {scale})")
    err = float((got - want).abs().max()) / scale
    if err > tol:
        raise AssertionError(f"{what}: gradient off by {err:.3e} of its scale > {tol}")
    return err


def _grads(fn, inputs, seed: int):
    """The inputs' gradients of sum(out * cotangent) for each output of
    ``fn``, with fixed random cotangents."""
    inputs = [x.detach().requires_grad_(True) for x in inputs]
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cots = [torch.randn(o.shape, generator=gen, device="cuda").to(o.dtype) for o in outs]
    return torch.autograd.grad(outs, inputs, cots)


def check_kernel_grads() -> dict:
    """(t1) Each kernel's autograd.Function on the card (the hand kernel
    forward, the plain closed-form backward) against autograd through its
    twin on the card, at the training paths' shapes."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {}
    for (label, b, s, h, k, hd, window), dtype in itertools.product(
            FLASH_GRAD_SHAPES, (torch.bfloat16, torch.float32)):
        q = torch.randn(b, s, h, hd, generator=gen, device="cuda").to(dtype)
        kk, vv = (torch.randn(b, s, k, hd, generator=gen, device="cuda").to(dtype)
                  for _ in range(2))
        got = _grads(lambda *a: flash_attention(*a, causal=True, window=window), (q, kk, vv), 1)
        want = _grads(lambda *a: attention_ref(*a, causal=True, window=window), (q, kk, vv), 1)
        err = max(_grad_err(f"flash {label} {dtype} d{n}", g, w, GRAD_TOL[dtype])
                  for n, g, w in zip("qkv", got, want))
        worst["flash_attention"] = max(worst.get("flash_attention", 0.0), err)
        log(f"  flash_attention gradients == autograd through the twin at {label} "
            f"(B {b}, S {s}, H {h}/{k}, hd {hd}, window {window}, {dtype}): dq, dk, dv "
            f"within {err:.3e} of their scale (tolerance {GRAD_TOL[dtype]})")
    label, b, s, h = WKV_GRAD_SHAPE
    args = wkv_inputs(b, s, h, "random", gen)
    got, want = _grads(wkv6, args, 2), _grads(wkv_twin, args, 2)
    worst["wkv6"] = max(_grad_err(f"wkv6 {label} d{n}", g, w, GRAD_TOL[torch.float32])
                        for n, g, w in zip(("r", "k", "v", "log_w", "u", "s0"), got, want))
    log(f"  wkv6 gradients == autograd through the twin at {label} (B {b}, S {s}, H {h}): "
        f"r, k, v, log_w, u, s0 within {worst['wkv6']:.3e} of their scale")
    label, b, s, w = LRU_GRAD_SHAPE
    args = lru_inputs(b, s, w, gen)
    got, want = _grads(rglru_scan, args, 3), _grads(rglru_ref, args, 3)
    worst["rglru_scan"] = max(_grad_err(f"rglru_scan {label} d{n}", g, x,
                                        GRAD_TOL[torch.float32])
                              for n, g, x in zip(("log_a", "b", "h0"), got, want))
    log(f"  rglru_scan gradients == autograd through the twin at {label} (B {b}, S {s}, "
        f"W {w}): log_a, b, h0 within {worst['rglru_scan']:.3e} of their scale")
    torch.cuda.empty_cache()
    return worst


def token_batch(cfg, n: int, seed: int = 0) -> dict:
    """One local step's node-stacked batch: tokens (n, 1, S + 1)."""
    return {"tokens": next(make_fl_token_batches(cfg.vocab_size, n, 1, TRAIN_SEQ, q=1,
                                                 seed=seed))["tokens"][0]}


def t1_weights(cfg, device: str) -> dict:
    """(t1)'s node-stacked weights: drawn by the card's generator from one
    seed, a leaf at a time, on ``device`` (the host CPU's copy equals the
    card's)."""
    single = build_model(cfg).init_fn(torch.Generator(device="cuda").manual_seed(3),
                                      device=device)
    return stack_for_nodes(single, GRAD_NODES)


def t1_host(arch: str, depth: int, dtypes) -> dict:
    """(t1)'s host half: each compute dtype's losses and gradients of the
    bundle's node-batched loss_fn on the host CPU, and its seconds."""
    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    host = t1_weights(cfg, "cpu")
    tokens = torch.as_tensor(token_batch(cfg, GRAD_NODES)["tokens"])
    out = {}
    for dt in dtypes:
        grad_fn = value_and_grad(build_model(dataclasses.replace(cfg, compute_dtype=dt)).loss_fn)
        t0 = time.perf_counter()
        losses, grads = grad_fn(host, {"tokens": tokens})
        out[dt] = (losses, grads, time.perf_counter() - t0)
    return out


def model_grad_paths(refs: dict) -> dict:
    """(t1) Full-width models at cut depth through the bundle's
    node-batched ``loss_fn`` and the trainer's ``value_and_grad``: every
    leaf's gradient on the card against the host CPU's from the same
    params and tokens (``refs[("t1", arch)]``, computed beside phases
    2-3), none all zero; the launches of one gradient evaluation (remat:
    each kernel twice a layer and node)."""
    counts = {}
    for arch, depth, dtypes in GRAD_MODELS:
        cfg = dataclasses.replace(get_config(arch), n_layers=depth)
        kinds = cfg.effective_pattern
        want = {}
        for name, kind in (("flash_attention", ("attention", "local_attention")),
                           ("wkv6", ("rwkv",)), ("rglru_scan", ("recurrent",))):
            layers = sum(k in kind for k in kinds)
            if layers:
                want[name] = 2 * layers * GRAD_NODES
        card = t1_weights(cfg, "cuda")
        tokens = torch.as_tensor(token_batch(cfg, GRAD_NODES)["tokens"])
        host = refs.pop(("t1", arch))
        for dt in dtypes:
            grad_fn = value_and_grad(build_model(
                dataclasses.replace(cfg, compute_dtype=dt)).loss_fn)
            zero_counts()
            t0 = time.perf_counter()
            losses, grads = grad_fn(card, {"tokens": tokens.cuda()})
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            expect_launches(f"{arch} x{depth} {dt} gradients", **want)
            for name, count in want.items():
                counts[name] = counts.get(name, 0) + count
            cpu_losses, cpu_grads, cpu_s = host.pop(dt)
            tol = GRAD_TOL[getattr(torch, dt)]
            rel = float(((losses.cpu() - cpu_losses).abs() / cpu_losses.abs()).max())
            if rel > tol:
                raise AssertionError(f"{arch} {dt}: losses {losses.tolist()} vs the CPU's "
                                     f"{cpu_losses.tolist()}")
            leaves = tree_leaves(grads)
            errs = [_grad_err(f"{arch} x{depth} {dt} {'/'.join(map(str, p))}", g,
                              c.cuda(), tol)
                    for (p, g), (_, c) in zip(leaves, tree_leaves(cpu_grads))]
            log(f"  {arch} at full width, {depth} layer(s) ({', '.join(kinds)}), {dt} "
                f"compute, {GRAD_NODES} nodes x S {TRAIN_SEQ}: launches {want}; losses "
                f"{[round(float(x), 4) for x in losses]} (CPU rel {rel:.2e}); all "
                f"{len(leaves)} leaves' gradients nonzero and within {max(errs):.3e} of "
                f"their scale of the host CPU's (tolerance {tol}); card {card_s:.1f} s, "
                f"CPU {cpu_s:.1f} s (beside phases 2-3)")
            del grads, cpu_grads, losses
        del card, host
        torch.cuda.empty_cache()
    return counts


def train_run(engine: str, nodes: int, device: str, params: dict, rounds: int):
    """SmolLM-360M through ``train_decentralized``: FD-DSGT Q = 2 on a
    ring, batch 1, S 128, the token stream of ``launch/train.py``."""
    cfg = get_config(TRAIN_ARCH)
    run = FLRunConfig(algorithm="dsgt", q=TRAIN_Q, topology="ring", n_nodes=nodes,
                      batch_per_node=1, alpha0=TRAIN_ALPHA0)
    stream = make_fl_token_batches(cfg.vocab_size, nodes, 1, TRAIN_SEQ, q=1, seed=0)
    steps = ({k: v[0] for k, v in b.items()} for b in stream)
    return train_decentralized(build_model(cfg).loss_fn, params, run, steps, rounds=rounds,
                               engine=engine, device=device)


def round_times(history) -> list:
    """Host clock per round (the trainer's ``wall_s`` is cumulative and
    each round ends reading its loss, a synchronization)."""
    wall = [0.0] + list(history.column("wall_s"))
    return [b - a for a, b in zip(wall, wall[1:])]


def check_round_at(card: str, state, engine, n: int) -> dict:
    """``fused_round_gt`` at (n, total) of the trained state: its first and
    last two scale chunks (the last ones past 2^31 bytes into each buffer)
    held against the twin on the same columns (every output of a chunk
    depends only on that chunk's columns), then timed against its byte
    bound."""
    c = state.comm
    g_prev = state.prev_grad * 0.5
    bufs = (state.params, state.tracker, state.prev_grad, g_prev, c["recon"],
            c["residual"], c["recon_t"], c["residual_t"])
    chunk, total = engine.scale_chunk, state.params.shape[1]
    w_off, w_self = engine.w_off, engine.w_self
    got = fused_round_gt(*bufs, w_off, w_self, ALPHA, scale_chunk=chunk)
    torch.cuda.synchronize()
    last = total - 2 * chunk
    for lo in (0, last):
        cols = slice(lo, lo + 2 * chunk)
        want = fused_round_gt_ref(*(b[:, cols].contiguous() for b in bufs), w_off, w_self,
                                  ALPHA, scale_chunk=chunk)
        for i, (a, b) in enumerate(zip(got, want)):
            a = a[:, lo // chunk:lo // chunk + 2] if i >= 6 else a[:, cols]
            if i < 2:
                err = float((a - b).abs().max())
                if err > 1e-5 * max(1.0, max(float(x[:, cols].abs().max()) for x in bufs)):
                    raise AssertionError(f"fused_round_gt at ({n}, {total:,}) columns "
                                         f"{lo}+: mixed off by {err}")
            elif not torch.equal(a, b):
                raise AssertionError(f"fused_round_gt at ({n}, {total:,}) columns {lo}+: "
                                     f"output {i} differs from the twin")
    del got, want
    k_ms = device_ms(lambda: fused_round_gt(*bufs, w_off, w_self, ALPHA, scale_chunk=chunk),
                     reps=10, warmup=2)
    nbytes = round_bytes(n, total, chunk, 2)
    bound_ms, bound_by = bound(nbytes, round_ops(n, total, chunk, 2, terms=mix_terms(w_off)))
    log(f"  fused_round_gt at ({n}, {total:,}) = {n * total:,} elements a buffer "
        f"({n * total * 4 / 1e9:.2f} GB): its first and last two chunks == the twin "
        f"(recon/res/scales bitwise, mixed within 1e-5), so the offsets past 2^31 bytes "
        f"land; kernel {k_ms * 1e3:.2f} us (median of 10), bound {bound_ms * 1e3:.2f} us "
        f"by {bound_by} ({nbytes / 1e9:.2f} GB at {HBM_BYTES_S / 1e12:.2f} TB/s), "
        f"{bound_ms / k_ms:.1%} of bound [{card}]")
    return {"shape": [n, total], "ms": k_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def training_paths(card: str) -> dict:
    """(t2) SmolLM-360M at full width and depth through
    ``train_decentralized``: one FD-DSGT round on the tree engine (4
    nodes), then one on the fused engine (2 nodes), each's round-1
    ``local_loss`` (the init's loss, forward only) against the host
    CPU's at full depth from the same init, then ``fused_round_gt`` at
    (2, 361.8M); the launches, host clock, device operations and busy
    share per round, peak memory."""
    cfg = get_config(TRAIN_ARCH)
    layers = cfg.n_layers
    out = {"counts": {}, "rows": {}}
    bundle = build_model(cfg)
    host = bundle.init_fn(torch.Generator().manual_seed(4), device="cpu")
    # each node's loss at the init on its first batch, on the host CPU: round
    # 1's local_loss is their mean (node i's stream does not depend on n)
    t0 = time.perf_counter()
    first = token_batch(cfg, TREE_NODES)["tokens"]
    with torch.no_grad():
        cpu_init = [float(lm_loss(host, cfg, {"tokens": torch.as_tensor(first[i])},
                                  remat=False)) for i in range(TREE_NODES)]
    log(f"  the init's per-node losses on the host CPU at full depth: "
        f"{[round(x, 5) for x in cpu_init]} ({time.perf_counter() - t0:.1f} s)")
    for engine, nodes in (("tree", TREE_NODES), ("fused", FUSED_NODES)):
        flash = T2_ROUNDS * TRAIN_Q * nodes * layers * 2
        want = {"flash_attention": flash}
        if engine == "fused":
            want["fused_round_gt"] = T2_ROUNDS
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        res = train_run(engine, nodes, "cuda", tree_map(lambda a: a.cuda(), host),
                        T2_ROUNDS)
        expect_launches(f"SmolLM-360M {engine} training", **want)
        for name, count in want.items():
            out["counts"][name] = out["counts"].get(name, 0) + count
        peak = torch.cuda.max_memory_allocated() / 1e9
        losses = list(res.history.column("loss"))
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"SmolLM-360M {engine}: losses {losses}")
        # one round: its host clock includes its first calls' warm-up
        step_ms = round_times(res.history)[0] * 1e3
        tokens_s = nodes * TRAIN_Q * TRAIN_SEQ / (step_ms / 1e3)
        log(f"  SmolLM-360M ({cfg.param_count():,} params, {layers} layers) on {engine}, "
            f"{nodes} nodes, FD-DSGT Q={TRAIN_Q}, S {TRAIN_SEQ}, {T2_ROUNDS} round: "
            f"launches {want}; losses {[round(float(x), 4) for x in losses]}; host clock of "
            f"the round {step_ms:.1f} ms (its first calls' warm-up included; "
            f"{tokens_s:,.0f} training tokens/s); peak memory {peak:.2f} GB [{card}]")
        local = res.history.rows()[0]["local_loss"]
        want_local = float(np.mean(cpu_init[:nodes]))
        if abs(local - want_local) > TRAIN_LOSS_RTOL * abs(want_local):
            raise AssertionError(f"SmolLM-360M {engine} round 1 local_loss: card {local} vs "
                                 f"the host CPU's {want_local}")
        log(f"  round 1's local_loss (the init params on each node's first batch), card vs "
            f"host CPU at full depth: {local:.5f} vs {want_local:.5f} (tolerance "
            f"{TRAIN_LOSS_RTOL} relative)")
        prof = profile_round(card, res, engine, nodes, step_ms)
        out["rows"][engine] = {"round_ms": step_ms, "tokens_s": tokens_s, "peak_gb": peak,
                               **prof}
        if engine == "fused":
            out["rows"]["fused_round_gt"] = check_round_at(card, res.state, res.engine,
                                                           nodes)
        del res
        torch.cuda.empty_cache()
    return out


def profile_round(card: str, res, engine: str, nodes: int, step_ms: float) -> dict:
    """One more round of the trained state under the profiler."""
    cfg = get_config(TRAIN_ARCH)
    fl = FLConfig(algorithm="dsgt", q=TRAIN_Q, n_nodes=nodes)
    round_fn = make_fl_round(build_model(cfg).loss_fn, inv_sqrt(TRAIN_ALPHA0), fl, res.engine)
    stream = make_fl_token_batches(cfg.vocab_size, nodes, 1, TRAIN_SEQ, q=TRAIN_Q, seed=9)
    batch, state = next(stream), res.state

    def one():
        nonlocal state
        state, _ = round_fn(state, batch)

    prof = profile_device(one, 1, f"SmolLM-360M {engine} {nodes}-node", "round", step_ms,
                          card)
    res.state = state
    return prof


def serve_consensus_path() -> dict:
    """(t3) ``examples/serve_consensus.py`` at full width: SmolLM-360M, 2
    nodes, 4 rounds, publish every 2; the tokens served from the snapshots
    equal an in-memory ``ServeEngine``'s on the consensus the trainer
    published. The trainer thread launches flash and the round kernel,
    the server the decode kernel: one writer a counter, read after the
    trainer is joined."""
    args = serve_consensus._parser().parse_args([
        "--arch", TRAIN_ARCH, "--full", "--nodes", "2", "--rounds", "4",
        "--publish-every", "2", "--device", "cuda"])
    cfg = get_config(TRAIN_ARCH)
    zero_counts()
    result = serve_consensus.run(args, keep_published=True)
    served = [r.shape[1] + args.new_tokens - 1 for r in result["requests"]]
    warm = result["requests"][0].shape[1] + 2 - 1
    want = {"flash_attention": args.rounds * args.q * args.nodes * cfg.n_layers * 2,
            "fused_round_gt": args.rounds,
            "decode_attention": cfg.n_layers * (sum(served) + warm)}
    expect_launches("serve_consensus", **want)
    held = serve_consensus.served_matches_in_memory(build_model(cfg), result, args)
    rounds = sorted({rnd for _, rnd in result["outputs"]})
    row = result["row"]
    log(f"  serve_consensus (SmolLM-360M full width, 2 nodes, 4 rounds, publish every 2): "
        f"launches {want}; losses {[round(x, 4) for x in result['losses']]}; "
        f"{held} requests served from snapshot rounds {rounds} == an in-memory "
        f"ServeEngine on the published consensus; {row['n_swaps']} hot swap(s), "
        f"{row['tokens_per_s']:.1f} tokens/s")
    shutil.rmtree(result["snap_dir"], ignore_errors=True)
    del result
    torch.cuda.empty_cache()
    return want


def training_counts(card: str, refs) -> dict:
    """(t1)-(t4) in order ((t1) in the host references' process,
    ``refs``); their launches summed by kernel, and (t2)'s rows."""
    counts = refs.run("t1")
    section("  -- (t2) SmolLM-360M at full width and depth")
    t2 = training_paths(card)
    section("  -- (t3) serve_consensus at full width")
    t3 = serve_consensus_path()
    section("  -- (t4) the entry points: launch/train.py and quickstart")
    t4 = entry_point_paths()
    for part in (t2["counts"], t3, t4):
        for name, count in part.items():
            counts[name] = counts.get(name, 0) + count
    return {"counts": counts, "rows": t2["rows"]}


def entry_point_paths() -> dict:
    """(t4) ``launch/train.py`` at its defaults (the TinyLlama smoke config,
    8 nodes, tree engine, 20 rounds of Q = 4) and with ``--fl-engine fused
    --fl-staleness-depth 2``, then ``examples/quickstart.py`` (25 rounds,
    then ``ServeEngine.generate``); each called in this process, so its
    launches count."""
    counts = {}
    smoke = get_config("tinyllama-1.1b", smoke=True)
    per_run = 20 * 4 * 8 * smoke.n_layers * 2
    for extra, want in (([], {"flash_attention": per_run}),
                        (["--fl-engine", "fused", "--fl-staleness-depth", "2"],
                         {"flash_attention": per_run, "wire_stage_gt": 20})):
        zero_counts()
        rec = train_launcher.main(["--arch", "tinyllama-1.1b", "--device", "cuda", *extra])
        expect_launches(f"launch/train.py {extra}", **want)
        if not (math.isfinite(rec["loss_last"]) and rec["loss_last"] < rec["loss_first"]):
            raise AssertionError(f"launch/train.py {extra}: loss {rec['loss_first']} -> "
                                 f"{rec['loss_last']}")
        log(f"  launch/train.py {' '.join(extra) or '(defaults)'}: launches {want}; "
            f"fl_schedule {rec['fl_schedule']}, loss {rec['loss_first']:.4f} -> "
            f"{rec['loss_last']:.4f}, {rec['wall_s']} s")
        for name, count in want.items():
            counts[name] = counts.get(name, 0) + count
    zero_counts()
    qs = quickstart.main(["--device", "cuda"])
    want = {"flash_attention": 25 * 4 * 8 * smoke.n_layers * 2,
            "decode_attention": (8 + 8 - 1) * smoke.n_layers}
    expect_launches("quickstart", **want)
    losses = qs["losses"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0] - 0.3):
        raise AssertionError(f"quickstart: losses {losses}")
    log(f"  quickstart: launches {want}; loss {losses[0]:.3f} -> {losses[-1]:.3f} "
        f"(the reference's bar: a fall of more than 0.3)")
    for name, count in want.items():
        counts[name] = counts.get(name, 0) + count
    return counts


def round_profile(card: str, schedule=None, engine: str = "fused", q: int = 10,
                  class_weight="balanced", rounds: int = 25, warmup: int = 5,
                  profiled: int = 5, topk=None, group=None, topology_program=None,
                  node_program=None, privacy=None, scale_chunk: int = 512,
                  scope=None, storage_dtype=None, mix_w="hospital20") -> dict:
    """Median host-clock time of one whole DSGT round with Q local steps
    (Q gradient evaluations, then the engine's comm step: one kernel
    launch on the fused engine, plus the PyTorch stale mix at depth k >=
    2; the exact fp32 mix on the tree engine; on the sharded engine, given
    its ``group``, one wire-stage launch, the all-gathers, the receive-side
    scatter and the mix), synchronized; then ``torch.profiler`` over
    ``profiled`` more rounds for the device's busy time and operation
    count per round and the host's costliest ops. ``mix_w``: the
    hospital graph by default, an explicit W, or None for the sharded
    engine's circulant torus over its group's node axes."""
    wire = "" if isinstance(mix_w, str) else (" torus" if mix_w is None else " all-gather")
    label = (f"DSGT Q={q} {engine}{wire} {schedule or 'sequential'}"
             + (f" top-{topk}" if topk else "")
             + "".join(f" {p}" for p in (topology_program, node_program, privacy, scope,
                                          storage_dtype) if p)
             + (f" chunk {scale_chunk}" if scale_chunk != 512 else ""))
    data = generate_ehr_cohort(seed=0)
    batcher = make_node_batcher(data, m=20, seed=1)
    cfg = FLConfig(algorithm="dsgt", q=q, n_nodes=20)
    stacked = stack_for_nodes(mlp_init(0, device="cuda"), 20)
    w = mixing_matrix(mix_w, 20) if isinstance(mix_w, str) else mix_w
    kw = dict(scale_chunk=scale_chunk, round_schedule=schedule, topk=topk,
              topology_program=topology_program, node_program=node_program, privacy=privacy,
              scope=scope, storage_dtype=storage_dtype)
    if group is not None:
        eng, params = ShardedFusedEngine.from_group(group, stacked, w=w, **kw)
    else:
        eng, params = get_engine(engine).simulated(w, stacked, **kw)
    round_fn = make_fl_round(make_mlp_loss(class_weights(class_weight)), inv_sqrt(0.02),
                             cfg, eng)
    state = init_fl_state(cfg, params, eng)
    batches = [stack_batches(batcher, cfg.q) for _ in range(rounds + warmup + profiled)]
    times = []
    for k, b in enumerate(batches[:rounds + warmup]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = round_fn(state, b)
        torch.cuda.synchronize()
        if k >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    r_ms = statistics.median(times)
    log(f"  one {label} round (20 hospitals, host clock, median of {rounds}): "
        f"{r_ms * 1e3:.1f} us [{card}]")

    def run():
        nonlocal state
        for b in batches[rounds + warmup:]:
            state, _ = round_fn(state, b)

    return {"round_ms": r_ms,
            **profile_device(run, profiled, label, "round", r_ms, card)}


def profile_device(run, n: int, label: str, unit: str, host_ms: float, card: str,
                   tables: bool = True) -> dict:
    """``torch.profiler`` over ``run()``, which does ``n`` units of work,
    read from the raw trace (the profiler's event tree is never built: it
    cost ~33 s at a training round's ~38,000 device operations): the
    device's operations and busy time per unit (the union of its
    intervals) and their share of ``host_ms`` (the unprofiled host-clock
    time of one unit); with ``tables``, the host's costliest operations
    by self time (each thread's intervals nested on a stack) and the
    device's by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev, host = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((e.start_ns(), e.duration_ns(), e.name()))
        elif tables:
            host.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.duration_ns(), e.name()))
    if not dev:
        log("  profiler: no device activity recorded; device busy time not measured")
        return {}
    dev.sort()
    busy, reach = 0, -1  # union of the device intervals, in ns
    for start, dur, _ in dev:
        busy += max(0, start + dur - max(start, reach))
        reach = max(reach, start + dur)
    busy_ms = busy / n / 1e6
    log(f"  profiler over {n} {label} {unit}s: {len(dev) / n:.0f} device "
        f"operations and {busy_ms * 1e3:.1f} us of device busy time per {unit}, "
        f"{busy_ms / host_ms:.2%} of the unprofiled {unit} time [{card}]")
    if tables:
        own: dict = {}
        for evs in host.values():
            evs.sort(key=lambda x: (x[0], -x[1]))
            selfs, stack = [d for _, d, _ in evs], []
            for k, (start, dur, _) in enumerate(evs):
                while stack and stack[-1][0] <= start:
                    stack.pop()
                if stack:  # the innermost open interval is the parent
                    selfs[stack[-1][1]] -= dur
                stack.append((start + dur, k))
            for (_, _, name), t in zip(evs, selfs):
                row = own.setdefault(name, [0, 0])
                row[0], row[1] = row[0] + t, row[1] + 1
        top = sorted(own.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
        log(f"  host ops by self time per {unit}: " + ", ".join(
            f"{name} {t / n / 1e3:.0f} us x{c / n:.0f}" for name, (t, c) in top))
        by_kernel: dict = {}
        for _, dur, name in dev:
            row = by_kernel.setdefault(name, [0, 0])
            row[0], row[1] = row[0] + dur, row[1] + 1
        on_card = sorted(by_kernel.items(), key=lambda kv: kv[1][0], reverse=True)[:6]
        log(f"  device time by op per {unit}: " + ", ".join(
            f"{name[:48]} {t / n / 1e3:.0f} us x{c / n:.0f}" for name, (t, c) in on_card))
    return {"device_ops": len(dev) / n, "busy_ms": busy_ms}


def timings(card: str, floor_ms: float) -> dict:
    """Each kernel and its twin at the main and the large shape (dense
    wire) and at the main shape with the top-64 wire, through
    ``kernel_bench`` -- the round kernels and the gossip stage with their
    cluster size, the earlier design's time in brackets and their distance
    from the launch floor; then whole rounds, sequential (fp32, then bf16
    storage: phase 7's profile) and bounded_staleness:k=2."""
    rows = kb.time_cases(kb.gossip_cases(earlier=EARLIER_US, floor_ms=floor_ms), card,
                         floor_ms)
    rows["rounds"] = {None: round_profile(card), BF16: round_profile(card, storage_dtype=BF16),
                      "bounded_staleness:k=2": round_profile(card, "bounded_staleness:k=2")}
    # the dynamic rounds (a) and (c) beside the static ones
    rows["rounds"]["churn"] = round_profile(card, topology_program=DYNAMIC_RUNS[0][3])
    rows["rounds"]["stragglers k=2"] = round_profile(
        card, DYNAMIC_RUNS[2][2], node_program=DYNAMIC_RUNS[2][4])
    # the Fig. 2 path: DSGT and FD-DSGT (Q = 100) on the tree engine, with
    # the paper's unweighted loss
    rows["rounds"]["tree"] = round_profile(card, engine="tree", q=1, class_weight=None)
    rows["rounds"]["tree q100"] = round_profile(card, engine="tree", q=100,
                                                class_weight=None, rounds=10,
                                                warmup=2, profiled=2)
    return rows


def two_pass_timings(card: str) -> dict:
    """The two-pass route at ``kb.FEDERATION`` (1,024 nodes, 262,144
    columns, ER p = 0.01), the gossip stage, DSGD and DSGT: the route, its
    wire stage and its mix, each against its twin, the mix also against
    ``torch.sparse.mm``, through ``kernel_bench``; then the wire stage's
    and the mix's µs beside the route's bound (the bytes the round must
    move once over 3.35 TB/s, or its operations); the mix alone on the
    1,024-node ring and the 512-node complete graph, with its plan."""
    rows = kb.time_cases(kb.two_pass_cases(), card)
    label, n, t = kb.FEDERATION[:3]
    w_off, _ = kb.federation_weights()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lists = sum(cols.numel() for cols, _ in gossip_wrappers.mix_lists(w_off.cpu())) / n
    log(f"  W_off: {kb.mix_terms(w_off):.2f} nonzeros a row (the mix's bound counts "
        f"these); the kernel runs {lists:.2f} terms a row (its lists)")
    for name in ("gossip_mix", "fused_round", "fused_round_gt"):
        wire_name = kb.ROUTE_WIRES[name][0].__name__
        route, wire = rows[(name, f"{label} route")], rows[(wire_name, f"{label} {name}")]
        mix = rows[("round_mix", f"{label} {name}")]
        cols, window, smem, grid = gossip_wrappers.mix_plan(
            n, t, 2 if name.endswith("gt") else 1, sms)
        log(f"  {name} two-pass route at ({n}, {t:,}): route {route['ms'] * 1e3:.2f} us = "
            f"{wire_name} {wire['ms'] * 1e3:.2f} ({wire['bound_ms'] / wire['ms']:.1%} of its "
            f"bound) + round_mix {mix['ms'] * 1e3:.2f} us ({mix['bound_ms'] / mix['ms']:.1%} "
            f"of its bound {mix['bound_ms'] * 1e3:.2f} by {mix['bound_by']}; torch.sparse.mm "
            f"{mix['library_ms'] * 1e3:.2f} us; strips of {cols} columns, {window} rows "
            f"staged, {smem} B, {grid} blocks), against the route's bound "
            f"{route['bound_ms'] * 1e3:.2f} us by {route['bound_by']} "
            f"({route['bound_ms'] / route['ms']:.1%} of it) [{card}]")
    for label, n, t, _ in kb.MIX_GRAPHS:
        mix = rows[("round_mix", f"{label} fused_round")]
        cols, window, smem, grid = gossip_wrappers.mix_plan(n, t, 1, sms)
        log(f"  round_mix alone at {label} ({n}, {t:,}): {mix['ms'] * 1e3:.2f} us, "
            f"{mix['bound_ms'] / mix['ms']:.1%} of its bound {mix['bound_ms'] * 1e3:.2f} us "
            f"by {mix['bound_by']}; torch.sparse.mm {mix['library_ms'] * 1e3:.2f} us; strips "
            f"of {cols} columns, {window} rows staged, {grid} blocks [{card}]")
    return rows


def axis_timings(card: str, group) -> dict:
    """Whole FD-DSGT Q = 10 rounds under this slice's axes beside the
    static round of the same engine in the same call: the sharded top-64
    round under ``node_churn`` (the dynamic round: W_r, ``nbr_recon_all``)
    and the fused round under ``dp:sigma=0.5,clip=1.0`` (two noise
    draws and the residual substitution a round)."""
    churn = DYNAMIC_RUNS[0][3]
    return {
        "sharded top-64 static": round_profile(card, engine="sharded_fused", topk=TOPK_MAIN,
                                               group=group),
        "sharded top-64 churn": round_profile(card, engine="sharded_fused", topk=TOPK_MAIN,
                                              group=group, topology_program=churn),
        "fused static": round_profile(card),
        "fused dp": round_profile(card, privacy=DP_SPEC),
    }


def compact_timings(card: str, group, floor_ms: float) -> dict:
    """Both compact wire-stage kernels and their twins at the main shape
    on the top-64 bitmap wire (``main``), the large shape on the same
    wire, and the main shape on the top-16 positions wire, through
    ``kernel_bench`` -- the DSGT kernel with its layout, the earlier
    design's time in brackets and its distance from the launch floor; no
    PyTorch call computes exact-k selection with int8 quantization
    (``library_ms`` null). Then whole sharded rounds (DSGT top-64,
    sequential) beside the fused engine's top-64 round."""
    rows = kb.time_cases(kb.compact_cases(earlier=EARLIER_US, floor_ms=floor_ms), card,
                         floor_ms)
    rows["rounds"] = {
        "sharded top-64": round_profile(card, engine="sharded_fused", topk=TOPK_MAIN,
                                        group=group),
        "fused top-64": round_profile(card, topk=TOPK_MAIN),
    }
    return rows


def attention_timings(card: str) -> dict:
    """Both attention kernels, their twins and the one PyTorch call that
    computes the same function (``scaled_dot_product_attention`` with
    GQA; a yardstick only, never on the path), bf16, at the serving paths'
    shapes and a large one, and the combine kernel on the large decode
    shape's partials (``kernel_bench.attention_cases``)."""
    return kb.time_cases(kb.attention_cases(), card)


def scan_timings(card: str, floor_ms: float) -> dict:
    """WKV-6 and the RG-LRU scan at the recurrent paths' prefill and decode
    shapes and at S 4096 (``kernel_bench.scan_cases``), beside the launch
    floor."""
    rows = {"launch_floor": floor_ms}
    rows.update(kb.time_cases(kb.scan_cases(), card, floor_ms))
    return rows


def decode_step_profile(card: str, engine, prompts: np.ndarray, label: str,
                        steps: int = 20, warmup: int = 5, profiled: int = 5,
                        frames=None, on_prompt=None) -> dict:
    """Whole serving decode steps at full width (batch 8, greedy, the
    prompt already in the cache; an enc-dec model's cross caches filled
    from ``frames``): the host-clock median of ``steps`` synchronized
    steps, tokens per second from it, then the profiler over ``profiled``
    more. ``on_prompt`` gets the logits of the prompt's last step."""
    tokens = torch.as_tensor(prompts, dtype=torch.long, device="cuda")
    caches = engine.new_caches(frames)
    for t in range(tokens.shape[1]):
        logits, caches, _ = engine.decode_step(tokens[:, t], caches)
    if on_prompt is not None:
        on_prompt(logits)
    cur = logits.float().argmax(-1)
    times = []
    for k in range(steps + warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, _ = engine.decode_step(cur, caches)
        cur = logits.float().argmax(-1)
        torch.cuda.synchronize()
        if k >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    b = tokens.shape[0]
    log(f"  one {label} decode step (batch {b}, host clock, median of {steps}): "
        f"{step_ms * 1e3:.1f} us, {b / step_ms * 1e3:.1f} tokens/s [{card}]")

    def run():
        nonlocal caches, cur
        for _ in range(profiled):
            logits, caches, _ = engine.decode_step(cur, caches)
            cur = logits.float().argmax(-1)

    return {"step_ms": step_ms, "tokens_s": b / step_ms * 1e3,
            **profile_device(run, profiled, f"{label} decode", "step", step_ms, card)}


def recurrent_step_profile(card: str, arch: str) -> dict:
    """The decode-step profile of one recurrent family at full width and
    depth, on the same seeded weights and prompts as its phase-3 run
    (drawn again: phase 3 freed them)."""
    cfg = get_config(arch)
    bundle = build_model(cfg)
    params = bundle.init_fn(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    engine = ServeEngine(bundle, params, max_seq=SERVE_MAX_SEQ, batch=SERVE_BATCH)
    out = decode_step_profile(card, engine, prompts[:, :PROFILE_PROMPT], arch)
    del engine, params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 6: the model zoo (z1)-(z4)
# ---------------------------------------------------------------------------

# (z1) the architectures no earlier phase serves, at their published
# widths, each through its entry points with random weights from a seeded
# CUDA generator. Depth is cut only as far as one 80 GB card forces with
# fp32 parameters (bf16 compute), from each config's param_count: fp32 a
# layer + embedding and head -- dbrx-132b 13.04 + 4.93 GB, llama4-scout
# 8.81 + 8.28, qwen2.5-32b 1.95 + 6.23, phi3-medium 1.36 + 4.11,
# internvl2-26b 1.56 + 4.56; whisper-medium (24 + 24 layers, ~3.6 GB)
# whole (None). Batch 8, 128 prompt + 32 new tokens (159 decode steps),
# max_seq 4096; whisper's 448, its native decoder length, and frames (8,
# 1500, 1024); InternVL2's prefill_fn also takes its 1,024 prefix
# embeddings.
ZOO_DEPTHS = {"dbrx-132b": 2, "llama4-scout-17b-a16e": 2, "qwen2.5-32b": 12,
              "phi3-medium-14b": 16, "internvl2-26b": 12, "whisper-medium": None}
ZOO_NEW, ZOO_WHISPER_MAX_SEQ = 32, 448
ZOO_PROFILE = dict(steps=12, warmup=3, profiled=3)
# (z2) the card against the host CPU, one arch per family, at full width
# and this depth (whisper: encoder and decoder), the same seeded weights:
# batch 2, 6 prompt + 4 new tokens. fp32 compute with fp32 caches: the
# prefill logits and every decode step's within ZOO_FP32_TOL of their
# scale, greedy tokens equal, MoE routing equal; bf16 compute (bf16
# caches, teacher-forced on the fp32 run's tokens): within
# SERVE_LOGIT_TOL wherever both devices route a row's token to the same
# experts. A bf16 routing choice may flip only on a near-tie: its top-k
# margin (the k-th largest router probability less the next, on the
# host) under ZOO_TIE_MARGIN; flipped rows are reported, not compared.
ZOO_CPU = {"dbrx-132b": 1, "qwen2.5-32b": 1, "internvl2-26b": 1, "whisper-medium": 2}
ZOO_CPU_BATCH, ZOO_CPU_PROMPT, ZOO_CPU_NEW = 2, 6, 4
ZOO_FP32_TOL, ZOO_TIE_MARGIN = 1e-4, 1e-2
# (z3) one gradient evaluation of the bundle's loss_fn at fp32, one node,
# batch 1, S 128 (whisper: its 1,500 frames), card against the host CPU:
# every leaf within GRAD_TOL[fp32] of its scale, none zero
ZOO_GRAD = {"llama4-scout-17b-a16e": 1, "whisper-medium": 2}
# (z4) the attention kernels timed at the zoo's path shapes, bf16:
# (label, B, C, live, H, K, hd) for decode -- the last decode step of
# the 4096-slot paths at head size 128 (groups 6, 5, 4), whisper's 448-slot
# self cache and its 1,500-slot cross cache -- and (label, B, Sq, Sk, H,
# K, hd, causal, window) for flash: the hd 128 prefills, InternVL2's
# prefix + prompt, whisper's encoder and its decoder's cross-attention
ZOO_DECODE_TIMES = [
    ("zoo hd128 group 6", SERVE_BATCH, SERVE_MAX_SEQ, SERVE_PROMPT + ZOO_NEW - 1, 48, 8, 128),
    ("zoo hd128 group 5", SERVE_BATCH, SERVE_MAX_SEQ, SERVE_PROMPT + ZOO_NEW - 1, 40, 8, 128),
    ("zoo hd128 group 4", SERVE_BATCH, SERVE_MAX_SEQ, SERVE_PROMPT + ZOO_NEW - 1, 40, 10, 128),
    ("whisper self", SERVE_BATCH, ZOO_WHISPER_MAX_SEQ, SERVE_PROMPT + ZOO_NEW - 1, 16, 16, 64),
    ("whisper cross", SERVE_BATCH, 1500, 1500, 16, 16, 64),
]
ZOO_FLASH_TIMES = [
    ("zoo hd128 group 6", SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 48, 8, 128, True, 0),
    ("zoo hd128 group 5", SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 40, 8, 128, True, 0),
    ("zoo hd128 group 4", SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 40, 10, 128, True, 0),
    ("internvl2 prefix + prompt", SERVE_BATCH, 1024 + SERVE_PROMPT, 1024 + SERVE_PROMPT,
     48, 8, 128, True, 0),
    ("whisper encoder", SERVE_BATCH, 1500, 1500, 16, 16, 64, False, 0),
    ("whisper cross", SERVE_BATCH, SERVE_PROMPT, 1500, 16, 16, 64, False, 0),
]


def zoo_config(arch: str, depth):
    """The arch's full config at ``depth`` layers (an enc-dec config: its
    encoder too), or uncut for None."""
    cfg = get_config(arch)
    if depth is None:
        return cfg
    if cfg.encoder is not None:
        return dataclasses.replace(cfg, n_layers=depth,
                                   encoder=dataclasses.replace(cfg.encoder, n_layers=depth))
    return dataclasses.replace(cfg, n_layers=depth)


def zoo_inputs(cfg, b: int, p: int, seed: int = 0):
    """Seeded prompts (b, p) and the family's frontend inputs: whisper's
    frames, InternVL2's prefix embeddings (numpy, fp32)."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, size=(b, p)).astype(np.int32)
    extra = {}
    if cfg.family == "audio":
        extra["frames"] = rng.normal(
            size=(b, cfg.encoder.seq_len, cfg.encoder.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        extra["prefix_embeds"] = rng.normal(
            size=(b, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return prompts, extra


def zoo_launches(cfg, steps: int) -> tuple:
    """The predicted (generate, prefill_fn) launches: the decode kernel
    once an attention layer and step (whisper twice: its cross-attention
    too), flash once an encoder layer in generate (encode runs once) and,
    in prefill_fn, once an attention (whisper: encoder, decoder self and
    cross) layer."""
    if cfg.family == "audio":
        enc = cfg.encoder.n_layers
        return ({"decode_attention": 2 * cfg.n_layers * steps, "flash_attention": enc},
                {"flash_attention": enc + 2 * cfg.n_layers})
    return {"decode_attention": cfg.n_layers * steps}, {"flash_attention": cfg.n_layers}


def _tensors(batch: dict, device) -> dict:
    """A batch of numpy arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def zoo_serving_path(card: str, arch: str) -> dict:
    """(z1) One architecture served at full width: ``generate`` and
    ``prefill_fn`` with their launches held to the prediction, the host
    clock a step, tokens/s and peak memory; then the decode-step profile,
    whose prompt replay's last logits meet the prefill's (bf16, not held
    for MoE: the capacity follows the token count, so a prefill of 1,024
    tokens and a step of 8 drop different assignments, as in the
    reference)."""
    cfg = zoo_config(arch, ZOO_DEPTHS[arch])
    bundle = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init_fn(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(a.numel() for _, a in tree_leaves(params))
    depth = (f"{cfg.encoder.n_layers} + {cfg.n_layers} layers" if cfg.encoder
             else f"{cfg.n_layers} of {get_config(arch).n_layers} layers")
    log(f"  {arch}: {n_params:,} parameters ({4 * n_params / 1e9:.2f} GB fp32, drawn in "
        f"{time.perf_counter() - t0:.1f} s), {depth}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} q-heads over {cfg.n_kv_heads} kv-heads, hd {cfg.head_dim}"
        + (f", {cfg.n_experts} experts top-{cfg.experts_per_token}"
           + (" + shared" if cfg.shared_expert else "") if cfg.family == "moe" else ""))
    prompts, extra = zoo_inputs(cfg, SERVE_BATCH, SERVE_PROMPT)
    max_seq = ZOO_WHISPER_MAX_SEQ if cfg.family == "audio" else SERVE_MAX_SEQ
    engine = ServeEngine(bundle, params, max_seq=max_seq, batch=SERVE_BATCH)
    steps = SERVE_PROMPT + ZOO_NEW - 1
    gen_want, pre_want = zoo_launches(cfg, steps)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=ZOO_NEW, temperature=0.0,
                          frames=extra.get("frames"))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    expect_launches(f"{arch} generate", **gen_want)
    new = out.tokens[:, SERVE_PROMPT:]
    if (out.tokens.shape != (SERVE_BATCH, SERVE_PROMPT + ZOO_NEW)
            or not (out.tokens[:, :SERVE_PROMPT] == prompts).all()
            or new.min() < 0 or new.max() >= cfg.vocab_size):
        raise AssertionError(f"{arch} generate: tokens {out.tokens.shape}, new in "
                             f"[{new.min()}, {new.max()}]")
    log(f"  generate (batch {SERVE_BATCH}, {SERVE_PROMPT} prompt + {ZOO_NEW} new tokens, "
        f"greedy, max_seq {max_seq}): launches {gen_want}; {gen_s:.2f} s, "
        f"{gen_s / steps * 1e3:.1f} ms a step on the host clock, "
        f"{SERVE_BATCH * ZOO_NEW / gen_s:.1f} new tokens/s end to end; row 0 continues "
        f"{new[0, :8].tolist()}")
    batch = _tensors({"tokens": prompts.astype(np.int64), **extra}, "cuda")
    zero_counts()
    with RouteLog() as routed:
        pre, _ = bundle.prefill_fn(params, batch)
    expect_launches(f"{arch} prefill", **pre_want)
    if pre.shape != (SERVE_BATCH, cfg.padded_vocab) or not torch.isfinite(pre.float()).all():
        raise AssertionError(f"{arch} prefill: logits {tuple(pre.shape)} not finite")
    counts = {name: gen_want.get(name, 0) + pre_want.get(name, 0)
              for name in ("decode_attention", "flash_attention")}
    note = ""
    if "prefix_embeds" in batch:  # the replay sees the prompt alone
        zero_counts()
        pre, _ = bundle.prefill_fn(params, {"tokens": batch["tokens"]})
        expect_launches(f"{arch} prefill without the prefix", **pre_want)
        counts["flash_attention"] += pre_want["flash_attention"]
        note = f" (with the {cfg.frontend_seq} prefix embeddings; again without them)"
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  prefill_fn{note}: launches {pre_want} a call; peak device memory "
        f"{peak:.2f} GB [{card}]")
    seen = {}
    row = decode_step_profile(card, engine, prompts, arch, frames=extra.get("frames"),
                              on_prompt=lambda lg: seen.update(logits=lg), **ZOO_PROFILE)
    if cfg.family == "moe":
        rel = float((pre.float() - seen["logits"].float()).abs().max()) / max(
            1.0, float(pre.float().abs().max()))
        dropped = [f"{float((~keep).float().mean()):.1%}" for _, keep, _ in routed.calls]
        log(f"  prefill vs the decode replay: {rel:.3e} of their scale (not held: the "
            f"capacity follows the token count; the prefill's {SERVE_BATCH * SERVE_PROMPT} "
            f"tokens dropped {dropped} of their assignments a layer, a step's "
            f"{SERVE_BATCH} none)")
    else:
        rel = _logit_diff(f"{arch} prefill vs decode replay", pre, seen["logits"])
        log(f"  prefill vs the decode replay at prompt token {SERVE_PROMPT}: max diff "
            f"{rel:.3e} of their scale (tolerance {SERVE_LOGIT_TOL}), "
            f"{_argmax_agree(f'{arch} prefill vs replay', pre, seen['logits'])}")
    del engine, params, pre, seen, batch
    torch.cuda.empty_cache()
    return {"counts": counts, "row": {**row, "gen_s": gen_s, "peak_gb": peak,
                                      "params": n_params}}


def routing_agreement(what: str, card_log: RouteLog, cpu_log: RouteLog,
                      exact: bool) -> list:
    """Per routed call, which tokens both devices sent to the same experts
    (and kept); the share of matching token-expert choices is logged, each
    flip with its top-k margin on the host. ``exact``: any flip raises;
    else a flip must be a near-tie (margin under ZOO_TIE_MARGIN)."""
    agree, total, same, flips = [], 0, 0, []
    for (te, tk, _), (ce, ck, cp) in zip(card_log.calls, cpu_log.calls, strict=True):
        n, k = te.shape
        chosen = te.sort(-1).values == ce.sort(-1).values
        same += int(chosen.sum())
        total += chosen.numel()
        ok = chosen.all(-1) & (tk == ck).reshape(n, k).all(-1)
        agree.append(ok)
        top = cp.sort(-1, descending=True).values
        for t in torch.nonzero(~ok).flatten().tolist():
            flips.append((t, float(top[t, k - 1] - top[t, k])))
    log(f"  {what}: {same}/{total} token-expert choices match between the card and the "
        f"host CPU ({same / max(total, 1):.4%}); "
        + (f"{len(flips)} flipped token(s), top-k margins "
           f"{[round(m, 6) for _, m in flips[:8]]}" if flips else "no flip"))
    if flips and (exact or max(m for _, m in flips) >= ZOO_TIE_MARGIN):
        raise AssertionError(f"{what}: routing flips {flips[:8]} (exact {exact}, near-tie "
                             f"margin {ZOO_TIE_MARGIN})")
    return agree


def zoo_caches(cfg, params: dict, b: int, cache_dtype, device, frames):
    """Zero decode state with caches in ``cache_dtype`` (whisper: the cross
    caches filled from ``frames``)."""
    if cfg.family == "audio":
        state = encdec_mod.encdec_init_decode_state(cfg, b, ZOO_WHISPER_MAX_SEQ, cache_dtype,
                                                    device)
        enc = encdec_mod.encode(params, cfg, torch.as_tensor(frames, device=device))
        return encdec_mod.encdec_fill_cross_kv(params, cfg, enc, state)
    return tfm.init_decode_state(cfg, b, SERVE_MAX_SEQ, cache_dtype=cache_dtype,
                                 device=device)


def zoo_decode(bundle, params: dict, prompts: np.ndarray, extra: dict, device,
               cache_dtype, forced=None):
    """The prompt, then ZOO_CPU_NEW greedy tokens (or ``forced``, teacher
    forcing the tokens after the prompt): (new tokens (B, n) on the host,
    each step's logits on the host)."""
    cfg = bundle.cfg
    caches = zoo_caches(cfg, params, prompts.shape[0], cache_dtype, device,
                        extra.get("frames"))
    toks = torch.as_tensor(prompts, dtype=torch.long, device=device)
    vocab = torch.arange(cfg.padded_vocab, device=device) < cfg.vocab_size
    logits_all, new, cur = [], [], None
    for t in range(ZOO_CPU_PROMPT + ZOO_CPU_NEW - 1):
        inp = toks[:, t] if t < ZOO_CPU_PROMPT else (
            forced[:, t - ZOO_CPU_PROMPT].to(device) if forced is not None else cur)
        logits, caches = bundle.decode_fn(params, inp, caches)
        logits_all.append(logits.float().cpu())
        if t >= ZOO_CPU_PROMPT - 1:
            cur = torch.where(vocab, logits.float(), -1e30).argmax(-1)
            new.append(cur.cpu())
    return torch.stack(new, 1), logits_all


def zoo_run(cfg, params: dict, device: str) -> dict:
    """(z2)'s runs on one device: each compute dtype's prefill logits and
    routing, then ZOO_CPU_NEW decode steps and their routing, and the
    seconds; bf16 teacher-forced on the fp32 run's tokens."""
    prompts, extra = zoo_inputs(cfg, ZOO_CPU_BATCH, ZOO_CPU_PROMPT, seed=1)
    batch = {"tokens": prompts.astype(np.int64), **extra}
    out, forced = {}, None
    for dt in ("float32", "bfloat16"):
        bundle = build_model(dataclasses.replace(cfg, compute_dtype=dt))
        t0 = time.perf_counter()
        with RouteLog() as pre_log:
            pre, _ = bundle.prefill_fn(params, _tensors(batch, device))
        with RouteLog() as dec_log:
            toks, steps = zoo_decode(bundle, params, prompts, extra, device,
                                     getattr(torch, dt), forced)
        out[dt] = (pre.float().cpu(), pre_log, toks, steps, dec_log, time.perf_counter() - t0)
        forced = toks
    return out


def zoo_weights(cfg, seed: int, device: str) -> dict:
    """A zoo arch's weights drawn by the card's generator from ``seed``, a
    leaf at a time, on ``device`` (the host CPU's copy equals the card's)."""
    return build_model(cfg).init_fn(torch.Generator(device="cuda").manual_seed(seed),
                                    device=device)


def z2_host(arch: str) -> dict:
    """(z2)'s host half: :func:`zoo_run` on the host CPU."""
    cfg = zoo_config(arch, ZOO_CPU[arch])
    return zoo_run(cfg, zoo_weights(cfg, 1, "cpu"), "cpu")


def zoo_card_vs_cpu(arch: str, refs: dict) -> None:
    """(z2) One arch at full width and cut depth on the card and on the
    host CPU from the same weights (the host's run computed beside phases
    2-3): prefill and decode at fp32 (tokens equal, logits within
    ZOO_FP32_TOL, routing equal) and at bf16 (logits within
    SERVE_LOGIT_TOL where routing agrees; flips only on near-ties)."""
    cfg = zoo_config(arch, ZOO_CPU[arch])
    host = refs.pop(("z2", arch))
    card_runs = zoo_run(cfg, zoo_weights(cfg, 1, "cuda"), "cuda")
    prompts, extra = zoo_inputs(cfg, ZOO_CPU_BATCH, ZOO_CPU_PROMPT, seed=1)
    moe = cfg.family == "moe"
    label = f"{arch} x{ZOO_CPU[arch]}"
    for dt in ("float32", "bfloat16"):
        pre_c, plog_c, tok_c, st_c, dlog_c, card_s = card_runs[dt]
        pre_h, plog_h, tok_h, st_h, dlog_h, cpu_s = host[dt]
        rows = torch.ones(ZOO_CPU_BATCH, dtype=torch.bool)
        step_rows = [rows] * len(st_c)
        if moe:
            exact = dt == "float32"
            agree = routing_agreement(f"{label} {dt} prefill routing", plog_c, plog_h, exact)
            # a row's last position, and a decode step's row, in every layer
            layers = cfg.n_layers
            rows = torch.stack([a.reshape(ZOO_CPU_BATCH, -1)[:, -1] for a in agree]).all(0)
            per_call = routing_agreement(f"{label} {dt} decode routing", dlog_c, dlog_h,
                                         exact)
            step_rows = [torch.stack(per_call[t * layers:(t + 1) * layers]).all(0)
                         for t in range(len(st_c))]
        tol = ZOO_FP32_TOL if dt == "float32" else SERVE_LOGIT_TOL
        worst = _logit_diff(f"{label} {dt} prefill card vs CPU", pre_c[rows], pre_h[rows],
                            tol) if rows.any() else 0.0
        for t, (a, b) in enumerate(zip(st_c, st_h)):
            if step_rows[t].any():
                worst = max(worst, _logit_diff(f"{label} {dt} step {t} card vs CPU",
                                               a[step_rows[t]], b[step_rows[t]], tol))
        if dt == "float32" and not torch.equal(tok_c, tok_h):
            raise AssertionError(f"{label} fp32 greedy tokens: card {tok_c.tolist()} "
                                 f"vs CPU {tok_h.tolist()}")
        compared = int(rows.sum()) + sum(int(r.sum()) for r in step_rows)
        log(f"  {label} {dt} compute, {'fp32' if dt == 'float32' else 'bf16'} caches, batch "
            f"{ZOO_CPU_BATCH}, {ZOO_CPU_PROMPT} prompt + {ZOO_CPU_NEW} new tokens"
            + (f", frames {tuple(extra['frames'].shape)}" if "frames" in extra else "")
            + (f", prefix {tuple(extra['prefix_embeds'].shape)}" if "prefix_embeds" in extra
               else "")
            + f": prefill and {len(st_c)} decode steps card vs host CPU within {worst:.3e} of "
            f"their scale (tolerance {tol}) over {compared} compared row logits"
            + (f"; greedy tokens equal {tok_c[0].tolist()}" if dt == "float32"
               else " (each device teacher-forced on its fp32 tokens, which are equal)")
            + f" (card {card_s:.1f} s, host CPU {cpu_s:.1f} s beside phases 2-3)")
    del card_runs, host
    torch.cuda.empty_cache()


def zoo_grad_batch(cfg) -> dict:
    """(z3)'s batch: one node's tokens and, for whisper, its frames."""
    batch = token_batch(cfg, 1, seed=2)
    if cfg.family == "audio":
        batch["frames"] = np.random.default_rng(2).normal(
            size=(1, 1, cfg.encoder.seq_len, cfg.encoder.d_model)).astype(np.float32)
    return batch


def zoo_grad_cfg(arch: str):
    return dataclasses.replace(zoo_config(arch, ZOO_GRAD[arch]), compute_dtype="float32")


def z3_host(arch: str) -> tuple:
    """(z3)'s host half: the losses, gradients and routing of one gradient
    evaluation on the host CPU, and its seconds."""
    cfg = zoo_grad_cfg(arch)
    host = stack_for_nodes(zoo_weights(cfg, 2, "cpu"), 1)
    grad_fn = value_and_grad(build_model(cfg).loss_fn)
    t0 = time.perf_counter()
    with RouteLog() as cpu_log:
        losses, grads = grad_fn(host, _tensors(zoo_grad_batch(cfg), "cpu"))
    return losses, grads, cpu_log, time.perf_counter() - t0


def zoo_grad_path(arch: str, refs: dict) -> dict:
    """(z3) One gradient evaluation of the bundle's node-batched loss_fn at
    fp32, one node, full width at cut depth, card against the host CPU
    (its evaluation computed beside phases 2-3): every leaf within
    GRAD_TOL of its scale, none zero; the flash launches of the
    evaluation held (remat: twice a decoder attention layer, whisper's
    encoder once, it runs without remat); MoE routing equal on both
    devices."""
    cfg = zoo_grad_cfg(arch)
    card = stack_for_nodes(zoo_weights(cfg, 2, "cuda"), 1)
    batch = zoo_grad_batch(cfg)
    if cfg.family == "audio":
        want = {"flash_attention": cfg.encoder.n_layers + 2 * 2 * cfg.n_layers}
    else:
        want = {"flash_attention": 2 * cfg.n_layers}
    grad_fn = value_and_grad(build_model(cfg).loss_fn)
    with RouteLog() as card_log:
        zero_counts()
        t0 = time.perf_counter()
        losses, grads = grad_fn(card, _tensors(batch, "cuda"))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        expect_launches(f"{arch} gradients", **want)
    cpu_losses, cpu_grads, cpu_log, cpu_s = refs.pop(("z3", arch))
    if cfg.family == "moe":  # the forward and the remat recompute, each a call
        routing_agreement(f"{arch} x{cfg.n_layers} fp32 training routing", card_log, cpu_log,
                          exact=True)
    tol = GRAD_TOL[torch.float32]
    rel = float(((losses.cpu() - cpu_losses).abs() / cpu_losses.abs()).max())
    if rel > tol:
        raise AssertionError(f"{arch}: losses {losses.tolist()} vs the CPU's "
                             f"{cpu_losses.tolist()}")
    leaves, cpu_leaves = tree_leaves(grads), dict(tree_leaves(cpu_grads))
    # a key projection's bias gets zero gradient in exact arithmetic (a
    # softmax over keys ignores a shift q . b_k shared by every score):
    # its rounding noise is held to its block's value-bias gradient scale
    errs = [_grad_err(f"{arch} {'/'.join(map(str, p))}", g, cpu_leaves[p].cuda(), tol,
                      float(cpu_leaves[p[:-2] + ("wv", "b")].abs().max())
                      if p[-2:] == ("wk", "b") else None)
            for p, g in leaves]
    log(f"  {arch} at full width, {cfg.n_layers} layer(s)"
        + (f" + {cfg.encoder.n_layers} encoder layers, frames "
           f"{tuple(batch['frames'].shape[1:])}" if cfg.encoder else "")
        + f", fp32, 1 node x S {TRAIN_SEQ}: launches {want}; loss {float(losses[0]):.4f} "
        f"(CPU rel {rel:.2e}"
        + (f", aux coefficient {cfg.router_aux_coef}" if cfg.family == "moe" else "")
        + f"); all {len(leaves)} leaves' gradients nonzero and within {max(errs):.3e} of "
        f"their scale of the host CPU's (tolerance {tol}); card {card_s:.1f} s, CPU "
        f"{cpu_s:.1f} s (beside phases 2-3)")
    del grads, cpu_grads, card
    torch.cuda.empty_cache()
    return want


def zoo_attention_timings(card: str) -> dict:
    """(z4) Both attention kernels against their twins and
    ``scaled_dot_product_attention`` at the zoo's path shapes."""
    gen = torch.Generator(device="cuda").manual_seed(4)

    def cases():  # built one at a time, each freed before the next
        for label, *shape in ZOO_DECODE_TIMES:
            yield kb.decode_case(label, *shape, gen)
        for label, *shape in ZOO_FLASH_TIMES:
            yield kb.flash_case(label, *shape, gen)

    return kb.time_cases(cases(), card)


def model_zoo(card: str, refs) -> dict:
    """Phase 6: (z1) each new architecture served, (z2) the card against
    the host CPU and (z3) gradients (in the host references' process,
    ``refs``), (z4) the attention kernels at the new shapes. Returns the
    launches the paths made and the rows."""
    counts, rows = {}, {}
    for arch in ZOO_DEPTHS:
        section(f"  -- (z1) {arch}")
        out = zoo_serving_path(card, arch)
        rows[arch] = out["row"]
        for name, count in out["counts"].items():
            counts[name] = counts.get(name, 0) + count
    section("  -- (z2) the card against the host CPU")
    refs.run("z2")
    section("  -- (z3) gradients at fp32")
    for name, count in refs.run("z3").items():
        counts[name] = counts.get(name, 0) + count
    refs.close()
    section("  -- (z4) the attention kernels at the zoo's shapes")
    rows["times"] = zoo_attention_timings(card)
    return {"counts": counts, "rows": rows}


# ---------------------------------------------------------------------------
# Phase 7: bf16 flat storage (b1)-(b4) and the standalone drivers (d)
# ---------------------------------------------------------------------------

BF16 = "bfloat16"
# bf16 storage against fp32 on the card, |bf16 - fp32| <= tol (1 + |fp32|)
# elementwise: the reference's own tolerance (tests/test_schedule.py)
BF16_VS_FP32_TOL = 5e-2
# (b1) the paper's configuration on the fused engine with bf16 storage:
# (label, run_fused_engine arguments, rounds, the kernel a round). Top-64
# runs 5 rounds, as phase 3's: the wire diverges past ~10 (queue 3 of
# ROADMAP.md), and a bf16 rounding flips its selection, so its bf16 run
# is held to the CPU twins and its gap to fp32 is printed, not held
BF16_RUNS = [("FD-DSGT sequential", {}, 20, "fused_round_gt"),
             ("FD-DSGT bounded_staleness:k=2", {"fl_schedule": "bounded_staleness:k=2"}, 20,
              "wire_stage_gt"),
             ("FD-DSGT top-64", {"topk": TOPK_MAIN}, 5, "fused_round_gt")]
BF16_DSGD_ROUNDS = 20
# (b2) the sharded engine with bf16 storage: (algorithm, topk); the dense
# wire is also held within one bf16 ulp after one round
BF16_SHARDED_RUNS = [("dsgt", None), ("dsgt", 16), ("dsgd", 16)]
# (d) the drivers on the card against the same drivers on the host CPU
DRIVER_RTOL = 1e-3
# (d) comm_bytes' rows, bytes a node and iteration for tinyllama-1.1b: the
# reference driver's (benchmarks/comm_bytes.py), hardware-independent
COMM_BYTES_ROWS = [8250362880, 88003870.72, 8800387072, 880038707.2, 88003870.72,
                   44001935.36, 22172850.24]
# the bf16 comm step's profile at the large shape (PERF.md section 6)
STEP_NODES, STEP_WIDTH = 64, 1 << 20


def bf16_gap(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(max |a - b|, elements past BF16_VS_FP32_TOL (1 + |b|))."""
    a, b = a.float(), b.float()
    d = (a - b).abs()
    return float(d.max()), int((d > BF16_VS_FP32_TOL * (1 + b.abs())).sum())


def check_bf16_state(what: str, state) -> None:
    """bf16 storage is still bf16 after the run; the wire state fp32."""
    bufs = [state.params] + ([state.tracker, state.prev_grad] if state.tracker is not None
                             else [])
    if any(b.dtype != torch.bfloat16 for b in bufs):
        raise AssertionError(f"{what}: storage widened to {[b.dtype for b in bufs]}")
    if any(v.dtype != torch.float32 for k, v in state.comm.items()
           if k.startswith(("recon", "residual", "mix_recon"))):
        raise AssertionError(f"{what}: wire state not fp32")


def bf16_fused_paths(fp32_runs: dict) -> dict:
    """(b1) The paper's configuration on ``fused`` with bf16 storage,
    through ``run_fused_engine`` and ``train_decentralized``: FD-DSGT Q =
    10 sequential, ``bounded_staleness:k=2`` and top-64, and FD-DSGD
    sequential. Each: one round kernel (or wire stage at k = 2) a round,
    the fp32 wire's bytes, the buffers still bf16, the same run on the
    CPU twins within 1e-2 relative loss and 0.02 bal_acc, and the fp32
    run on the card (phase 3's, ``fp32_runs``; FD-DSGD's runs here)
    within the reference's 5e-2 (top-64: printed)."""
    launches = {}
    for label, kw, rounds, kernel in BF16_RUNS:
        zero_counts()
        out = run_fused_engine(rounds=rounds, q=10, device="cuda", storage_dtype=BF16, **kw)
        expect_launches(f"bf16 {label}", **{kernel: rounds})
        launches[kernel] = launches.get(kernel, 0) + rounds
        check_bf16_state(f"bf16 {label}", out["state"])
        want_bytes = WIRE_TOP64 if "topk" in kw else WIRE_DSGT
        if out["wire_bytes"] != want_bytes:
            raise AssertionError(f"bf16 {label}: wire {out['wire_bytes']} != {want_bytes}")
        against_cpu(f"bf16 {label}", out, rounds=rounds, q=10, storage_dtype=BF16, **kw)
        fp32 = fp32_runs[label]
        gap, bad = bf16_gap(out["state"].params, fp32["state"].params)
        if bad and "topk" not in kw:
            raise AssertionError(f"bf16 {label}: {bad} elements past {BF16_VS_FP32_TOL} of "
                                 f"the fp32 run (max diff {gap:.3e})")
        log(f"  bf16 {label}, {rounds} rounds x Q=10: {rounds} {kernel} launches, wire "
            f"{out['wire_bytes']:,.0f} B/round (fp32's), params/tracker/prev_grad bf16; vs "
            f"the fp32 run on the card: params max diff {gap:.3e}, {bad} past "
            f"{BF16_VS_FP32_TOL} (1 + |fp32|), final loss {out['losses'][-1]:.4f} vs "
            f"{fp32['losses'][-1]:.4f}, bal_acc {out['bal_acc']:.4f} vs {fp32['bal_acc']:.4f}")
    zero_counts()
    res = dsgd_run(BF16_DSGD_ROUNDS, storage_dtype=BF16)
    expect_launches("bf16 FD-DSGD", fused_round=BF16_DSGD_ROUNDS)
    launches["fused_round"] = BF16_DSGD_ROUNDS
    per_round = res.history.column("comm_bytes")[-1] / BF16_DSGD_ROUNDS
    check_bf16_state("bf16 FD-DSGD", res.state)
    cpu = dsgd_run(BF16_DSGD_ROUNDS, device="cpu", storage_dtype=BF16)
    fp32 = dsgd_run(BF16_DSGD_ROUNDS)
    loss, cpu_loss = res.history.column("loss"), cpu.history.column("loss")
    rel = float(np.max(np.abs(loss - cpu_loss) / np.abs(cpu_loss)))
    gap, bad = bf16_gap(res.state.params, fp32.state.params)
    if per_round != WIRE_DSGD or rel > 1e-2 or bad:
        raise AssertionError(f"bf16 FD-DSGD: wire {per_round}, loss vs the CPU twins rel "
                             f"{rel}, {bad} elements past {BF16_VS_FP32_TOL} of fp32")
    log(f"  bf16 FD-DSGD, {BF16_DSGD_ROUNDS} rounds x Q=10: {BF16_DSGD_ROUNDS} fused_round "
        f"launches, wire {per_round:,.0f} B/round; vs the CPU twins: loss rel {rel:.2e}; "
        f"vs fp32 on the card: params max diff {gap:.3e}")
    return launches


def bf16_sharded_path() -> dict:
    """(b2) ``sharded_fused`` with bf16 storage on a one-rank NCCL group,
    through ``run_sharded_engine``, 5 rounds at Q = 10 on the dense int8
    wire (DSGT) and the compact top-16 wire (DSGT, DSGD): one wire-stage
    launch a round, the buffers bf16, the loss within rtol 1e-3 of the
    bf16 fused engine on the card every round; the dense wire's params and
    tracker within one bf16 ulp of the fused engine's after one round (the
    compact wire keeps k of the MLP's exact ties where the fused mask
    keeps all, so it is held on the loss: phase 3's rule)."""
    group = start_group(0, 1, os.path.join(tempfile.mkdtemp(), "store"), device="cuda")
    launches = {}
    try:
        for algorithm, topk in BF16_SHARDED_RUNS:
            wires = 2 if algorithm == "dsgt" else 1
            kernel = {(True, 1): "wire_stage_compact", (True, 2): "wire_stage_gt_compact",
                      (False, 2): "wire_stage_gt"}[(topk is not None, wires)]
            label = f"bf16 sharded {algorithm.upper()} " + (f"top-{topk}" if topk else "int8")
            zero_counts()
            out = run_sharded_engine(group, rounds=SHARDED_ROUNDS, q=10, algorithm=algorithm,
                                     topk=topk, log=False, storage_dtype=BF16)
            expect_launches(label, **{kernel: SHARDED_ROUNDS})
            launches[kernel] = launches.get(kernel, 0) + SHARDED_ROUNDS
            check_bf16_state(label, out["state"])
            state, losses, _ = fused_oracle(algorithm, "sequential", topk, storage_dtype=BF16)
            rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], losses))
            if rel > 1e-3 or out["wire_bytes"] != SHARDED_WIRE[(topk, algorithm)]:
                raise AssertionError(f"{label}: loss rel {rel} vs the bf16 fused engine, "
                                     f"wire {out['wire_bytes']}")
            note = ""
            if topk is None:
                one = run_sharded_engine(group, rounds=1, q=10, algorithm=algorithm,
                                         log=False, storage_dtype=BF16)["state"]
                want, _, _ = fused_oracle(algorithm, "sequential", None, rounds=1,
                                          storage_dtype=BF16)
                d = max(kb.bf16_ulp_err(f"{label} params", one.params, want.params),
                        kb.bf16_ulp_err(f"{label} tracker", one.tracker, want.tracker))
                note = (f"; after one round within {d:.2f} bf16 ulps at each column's "
                        "scale")
            log(f"  {label}, {SHARDED_ROUNDS} rounds x Q=10: {SHARDED_ROUNDS} {kernel} "
                f"launches, wire {out['wire_bytes']:,.0f} B/round, buffers bf16; vs the bf16 "
                f"fused engine: loss rel {rel:.2e}{note}")
    finally:
        stop_group(group)
    return launches


def bf16_snapshot_path() -> dict:
    """(b3) SmolLM-360M at full width (seeded random weights) written as
    a bf16 consensus snapshot (half the fp32 blob), mapped, staged and
    served by ``ServeEngine.from_snapshot``: ``generate`` with a second
    bf16 snapshot hot-swapped in by ``publish_snapshot``; the prefill
    logits of the served bf16 weights against the fp32 snapshot's of the
    same state within SERVE_LOGIT_TOL of their scale."""
    cfg = get_config(SERVE_ARCH)
    bundle = build_model(cfg)
    weights = [bundle.init_fn(torch.Generator(device="cuda").manual_seed(s), device="cuda")
               for s in (0, 1)]
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(SERVE_BATCH, SNAPSHOT_PROMPT)).astype(np.int32)
    d = tempfile.mkdtemp()
    launches = {}
    try:
        flat, layout = pack(tree_map(lambda p: p[None], weights[0]))
        header32 = write_snapshot(os.path.join(d, "fp32"), flat, layout, round_frontier=1)
        del flat
        write_s = []
        for rnd, w in enumerate(weights, 1):
            flat, layout = pack(tree_map(lambda p: p[None], w), buffer_dtype=torch.bfloat16)
            t0 = time.perf_counter()
            header = write_snapshot(os.path.join(d, "bf16"), flat, layout, round_frontier=rnd)
            write_s.append(time.perf_counter() - t0)
            del flat
        blobs = []
        for h in (header32, header):
            with open(h) as f:
                blobs.append(json.load(f)["blob_bytes"])
        t0 = time.perf_counter()
        snaps = [load_snapshot(os.path.join(d, "bf16"), rnd, template=weights[0])
                 for rnd in (1, 2)]
        map_ms = (time.perf_counter() - t0) * 1e3 / 2
        if snaps[0].flat.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 snapshot mapped as {snaps[0].flat.dtype}")
        kw = dict(max_seq=SERVE_MAX_SEQ, batch=SERVE_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = ServeEngine.from_snapshot(bundle, snaps[0], stage=True, **kw)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        steps = SNAPSHOT_PROMPT + SNAPSHOT_NEW - 1
        n_decode = cfg.n_layers * steps
        step, calls = served.decode_step, {"n": 0}

        def publishing_step(tokens, caches):
            out = step(tokens, caches)
            calls["n"] += 1
            if calls["n"] == SNAPSHOT_SWAP_AT:
                served.publish_snapshot(snaps[1])
            return out

        served.decode_step = publishing_step
        zero_counts()
        out = served.generate(prompts, max_new_tokens=SNAPSHOT_NEW, temperature=0.0)
        expect_launches("bf16 snapshot serving generate", decode_attention=n_decode)
        launches["decode_attention"] = n_decode
        if (out.swap_steps != (SNAPSHOT_SWAP_AT,) or served.snapshot_round != 2
                or served._active_ref is not snaps[1]):
            raise AssertionError(f"bf16 snapshot hot swap: steps {out.swap_steps}, round "
                                 f"{served.snapshot_round}")
        fp32 = load_snapshot(os.path.join(d, "fp32"), 1, template=weights[0])
        staged = ServeEngine.from_snapshot(bundle, fp32, stage=True, **kw).params
        bf16 = ServeEngine.from_snapshot(bundle, snaps[0], stage=True, **kw).params
        tokens = {"tokens": torch.as_tensor(prompts, device="cuda")}
        zero_counts()
        got, _ = bundle.prefill_fn(bf16, tokens)
        want, _ = bundle.prefill_fn(staged, tokens)
        expect_launches("bf16 snapshot prefill", flash_attention=2 * cfg.n_layers)
        launches["flash_attention"] = 2 * cfg.n_layers
        rel = _logit_diff("SmolLM-360M from its bf16 snapshot vs fp32", got, want)
        log(f"  {cfg.name} as a bf16 snapshot: {blobs[1] / 1e9:.3f} GB blob (fp32 "
            f"{blobs[0] / 1e9:.3f} GB) written in {write_s[0]:.2f} / {write_s[1]:.2f} s, mapped "
            f"in {map_ms:.2f} ms, staged onto the card in {stage_s:.2f} s; generate "
            f"(batch {SERVE_BATCH}, {SNAPSHOT_PROMPT} + {SNAPSHOT_NEW} tokens) with "
            f"publish_snapshot after step {SNAPSHOT_SWAP_AT}: swapped at {out.swap_steps} "
            f"({served.swap_pauses[0] * 1e6:.1f} us pause), {n_decode} decode_attention "
            f"launches; prefill logits vs the fp32 snapshot's: {rel:.3e} of their scale "
            f"(tolerance {SERVE_LOGIT_TOL})")
        del served, snaps, fp32, staged, bf16, weights
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return launches


@contextlib.contextmanager
def memory_stages():
    """Peak allocated device memory of a fused-engine FD-DSGT run by stage,
    and the storage dtypes of its final state. Stages: set-up (before the
    first gradient), gradients (each evaluation), local updates (between
    them and the comm steps), the comm step's own work (upcasts, stores,
    wire bookkeeping), the round kernel (entered with its inputs alive;
    its peak adds the outputs) and the round's metrics. Wraps
    ``FusedEngine.make_eval_grads``, ``make_comm_step``, ``_metrics`` and
    the engine module's ``fused_round_gt`` while open; yields ``(peaks,
    seen)``: stage -> bytes, and the final state's dtypes with the bytes
    allocated as the round kernel starts (``kernel_entry``)."""
    peaks, seen, where = {}, {"kernel_entry": 0}, ["set-up"]
    own = {k: FusedEngine.__dict__.get(k) for k in ("make_eval_grads", "make_comm_step",
                                                       "_metrics")}
    make_eval, make_comm, metrics = (FusedEngine.make_eval_grads, FusedEngine.make_comm_step,
                                     FusedEngine._metrics)
    kernel = engine_module.fused_round_gt

    def enter(stage: str) -> str:
        peaks[where[0]] = max(peaks.get(where[0], 0), torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        previous, where[0] = where[0], stage
        return previous

    def staged(fn, stage: str, back=None):
        def run(*args, **kw):
            previous = enter(stage)
            try:
                return fn(*args, **kw)
            finally:
                enter(back or previous)
        return run

    def eval_probe(self, grad_fn):
        fn = make_eval(self, grad_fn)

        def probed(params, batch):
            back = "comm step" if where[0] == "comm step" else "local updates"
            return staged(fn, "gradients", back)(params, batch)
        return probed

    def comm_probe(self, *args):
        step = staged(make_comm(self, *args), "comm step", "local updates")

        def probed(state, batch):
            new, out = step(state, batch)
            seen.update(params=new.params.dtype, tracker=new.tracker.dtype,
                        prev_grad=new.prev_grad.dtype,
                        **{k: v.dtype for k, v in new.comm.items()
                           if k.startswith(("recon", "residual"))})
            return new, out
        return probed

    def kernel_probe(*args, **kw):
        seen["kernel_entry"] = max(seen["kernel_entry"], torch.cuda.memory_allocated())
        return staged(kernel, "round kernel")(*args, **kw)

    FusedEngine.make_eval_grads, FusedEngine.make_comm_step = eval_probe, comm_probe
    FusedEngine._metrics = staged(metrics, "metrics")
    engine_module.fused_round_gt = kernel_probe
    torch.cuda.reset_peak_memory_stats()
    try:
        yield peaks, seen
    finally:
        enter("done")
        engine_module.fused_round_gt = kernel
        for name, fn in own.items():
            if fn is None:
                delattr(FusedEngine, name)
            else:
                setattr(FusedEngine, name, fn)


def bf16_training_path(card: str) -> dict:
    """(b4) ``launch/train.py --no-smoke --fl-engine fused``: SmolLM-360M at
    full width and depth, 2 nodes, FD-DSGT Q = 2, 3 rounds, batch 1, S 128
    ((t2)'s configuration) through the user entry point, with fp32
    storage and then ``--storage-dtype bfloat16``: their launches, losses,
    the storage dtypes of the launcher's final state, and the card's peak
    memory by stage (:func:`memory_stages`) beside what earlier phases
    still hold, side by side."""
    cfg = get_config(TRAIN_ARCH)
    want = {"flash_attention": TRAIN_ROUNDS * TRAIN_Q * FUSED_NODES * cfg.n_layers * 2,
            "fused_round_gt": TRAIN_ROUNDS}
    counts, peaks = {}, {}
    for storage in ("float32", BF16):
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        zero_counts()
        with memory_stages() as (stages, seen):
            rec = train_launcher.main([
                "--arch", TRAIN_ARCH, "--no-smoke", "--fl-engine", "fused", "--storage-dtype",
                storage, "--nodes", str(FUSED_NODES), "--rounds", str(TRAIN_ROUNDS), "--q",
                str(TRAIN_Q), "--batch-per-node", "1", "--seq-len", str(TRAIN_SEQ),
                "--alpha0", str(TRAIN_ALPHA0), "--log-every", "0", "--device", "cuda"])
        expect_launches(f"launch/train.py --no-smoke {storage} fused", **want)
        entry = seen.pop("kernel_entry")
        stored = dict.fromkeys(("params", "tracker", "prev_grad"), getattr(torch, storage))
        if any(seen[k] != d for k, d in stored.items()) or any(
                d != torch.float32 for k, d in seen.items() if k not in stored):
            raise AssertionError(f"launch/train.py --storage-dtype {storage}: final state {seen}")
        peaks[storage] = max(stages.values()) / 1e9
        if not (math.isfinite(rec["loss_first"]) and math.isfinite(rec["loss_last"])):
            raise AssertionError(f"{storage} training: loss {rec['loss_first']} -> "
                                 f"{rec['loss_last']}")
        for name, count in want.items():
            counts[name] = counts.get(name, 0) + count
        log(f"  launch/train.py --no-smoke --fl-engine fused --storage-dtype {storage} "
            f"({cfg.name}, {cfg.param_count():,} params, {FUSED_NODES} nodes, FD-DSGT "
            f"Q={TRAIN_Q}, S {TRAIN_SEQ}, {TRAIN_ROUNDS} rounds): launches {want}; loss "
            f"{rec['loss_first']:.4f} -> {rec['loss_last']:.4f}, {rec['wall_s']} s; the "
            f"final state's params/tracker/prev_grad {storage}, its wire state float32; "
            f"peak memory {peaks[storage]:.2f} GB; by stage "
            + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in stages.items())
            + f" GB; {entry / 1e9:.2f} GB allocated as the round kernel starts; "
            f"{held / 1e9:.2f} GB held by earlier phases [{card}]")
    log(f"  peak memory, bf16 storage against fp32 in this call: {peaks[BF16]:.2f} against "
        f"{peaks['float32']:.2f} GB")
    return counts


def driver_tables(host: dict) -> None:
    """(d) ``benchmarks/run.py --fast`` on the card: Theorem 1, the
    communication-bytes table and the ablations (Fig. 2 runs uncut in
    phase 3 and the kernels are phase 4), no hand kernel launched; each
    table's JSON written; Theorem 1's measures and every ablation row
    within rtol 1e-3 of the same drivers on the host CPU
    (``host_references``), comm_bytes equal to the reference driver's
    rows."""
    d = tempfile.mkdtemp()
    try:
        zero_counts()
        t0 = time.perf_counter()
        res = run_all.main(["--fast", "--skip", "fig2,kernels", "--device", "cuda",
                            "--out-dir", d])
        card_s = time.perf_counter() - t0
        expect_launches("run.py --fast")
        wrote = sorted(os.listdir(d))
        if wrote != sorted(run_all.OUTPUTS[t] for t in ("thm1", "comm_bytes", "ablations")):
            raise AssertionError(f"run.py wrote {wrote}")
        thm1, abl, cpu_s = host["thm1"], host["ablations"], host["drivers_s"]
        pairs = [(f"thm1 N={n}", res["thm1"]["measure"][n], thm1["measure"][n])
                 for n in thm1_speedup.NODES]
        for table in ("topology", "drift"):
            for key, row in abl[table].items():
                got = res["ablations"][table][key]
                flat = row.get("dist_by_q", row)
                for name, want in flat.items():
                    mine = got.get("dist_by_q", got)[name]
                    pairs.append((f"ablations {table} {key} {name}", mine, want))
        worst = max(abs(a - b) / abs(b) for _, a, b in pairs)
        bad = [(w, a, b) for w, a, b in pairs if abs(a - b) > DRIVER_RTOL * abs(b)]
        rows = [r["bytes_per_iter_per_node"] for r in res["comm_bytes"]["rows"]]
        if bad or rows != COMM_BYTES_ROWS:
            raise AssertionError(f"(d) drivers off the host CPU's: {bad[:4]}; comm_bytes "
                                 f"{rows}")
        log(f"  run.py --fast on the card in {card_s:.1f} s (thm1, comm_bytes, ablations; "
            f"the host CPU's drivers {cpu_s:.1f} s while the kernels built): thm1 ratios N4/N8 "
            f"{res['thm1']['ratio_4_8']:.2f}, N8/N16 {res['thm1']['ratio_8_16']:.2f}; "
            f"{len(pairs)} measures within {worst:.2e} (rtol {DRIVER_RTOL}) of the host "
            f"CPU's; comm_bytes' 7 rows equal the reference's")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def comm_step_profile(card: str, storage_dtype) -> dict:
    """One FD-DSGT comm step of the fused engine at (64, 1,048,576) on
    the 8 x 8 torus (a quadratic loss), with ``storage_dtype`` storage:
    host clock (median of 5), device time by CUDA events (median of 20)
    and the profiler's operations over 3 steps."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = {"p": torch.randn(STEP_NODES, STEP_WIDTH, generator=gen, device="cuda")}
    target = {"t": torch.randn(STEP_NODES, STEP_WIDTH, generator=gen, device="cuda")}
    eng, flat = FusedEngine.simulated(mixing_matrix("torus:8x8", STEP_NODES), params,
                                      scale_chunk=512, storage_dtype=storage_dtype)
    cfg = FLConfig(algorithm="dsgt", q=1, n_nodes=STEP_NODES)

    def loss(p, b):
        return 0.5 * ((p["p"] - b["t"]) ** 2).sum(dim=1)

    comm = eng.make_comm_step(eng.make_eval_grads(value_and_grad(loss)), inv_sqrt(0.02), cfg)
    state = init_fl_state(cfg, flat, eng)
    times = []
    for k in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = comm(state, target)
        torch.cuda.synchronize()
        if k >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    host = statistics.median(times)
    # CUDA events around the whole step (the spin kernel ahead of it holds
    # the stream while the host enqueues): the step's device time, which
    # the profiler's trace can undercount late in a long process
    events_ms = device_ms(lambda: comm(state, target), reps=20, warmup=2)
    label = f"DSGT comm step at ({STEP_NODES}, {STEP_WIDTH:,}) {storage_dtype or 'float32'}"
    log(f"  one {label}: host clock {host * 1e3:.1f} us (median of 5), device "
        f"{events_ms * 1e3:.1f} us (CUDA events, median of 20) [{card}]")

    def run():
        nonlocal state
        for _ in range(3):
            state, _ = comm(state, target)

    out = {"step_ms": host, "device_ms": events_ms,
           **profile_device(run, 3, label, "step", host, card)}
    del state, comm, eng, flat, params, target
    torch.cuda.empty_cache()
    return out


def bf16_profiles(card: str, rounds: dict) -> dict:
    """Where the time goes with bf16 storage: the FD-DSGT Q = 10
    sequential round at (20, 1536), bf16 against fp32 (phase 4 profiled
    them one after the other: ``rounds``), then one DSGT comm step at (64,
    1,048,576), fp32 beside bf16."""
    f32, b16 = rounds[None], rounds[BF16]
    if "busy_ms" in f32 and "busy_ms" in b16:
        log(f"  the (20, 1536) round, bf16 storage against fp32 (phase 4): host clock "
            f"{b16['round_ms'] * 1e3:.1f} against {f32['round_ms'] * 1e3:.1f} us, device "
            f"operations {b16['device_ops']:.0f} against {f32['device_ops']:.0f}, device busy "
            f"{b16['busy_ms'] * 1e3:.1f} against {f32['busy_ms'] * 1e3:.1f} us [{card}]")
    return {"step fp32": comm_step_profile(card, None),
            "step bf16": comm_step_profile(card, BF16)}


def bf16_and_drivers(card: str, host: dict, fp32_runs: dict, rounds: dict) -> dict:
    """Phase 7: (b1)-(b4), (d) and the profiles; the launches by kernel.
    ``host`` holds the host CPU's driver runs, ``fp32_runs`` phase 3's
    fp32 runs of (b1)'s configurations, ``rounds`` phase 4's round
    profiles."""
    counts = {}
    section("  -- (b1) bf16 storage on the fused engine")
    parts = [bf16_fused_paths(fp32_runs)]
    section("  -- (b2) bf16 storage on the sharded engine (one-rank NCCL group)")
    parts.append(bf16_sharded_path())
    section("  -- (b3) SmolLM-360M from a bf16 snapshot")
    parts.append(bf16_snapshot_path())
    section("  -- (b4) launch/train.py --no-smoke with bf16 storage")
    parts.append(bf16_training_path(card))
    section("  -- (d) the standalone drivers through run.py --fast")
    driver_tables(host)
    section("  -- profiles: bf16 storage beside fp32")
    bf16_profiles(card, rounds)
    for part in parts:
        for name, count in part.items():
            counts[name] = counts.get(name, 0) + count
    return counts


# ---------------------------------------------------------------------------
# phase 8: the circulant torus wire and the two-axis layout
# ---------------------------------------------------------------------------

# (c1) the paper's configuration (20 hospitals, the 42->32->2 MLP at
# (20, 1536), chunk 512, alpha = 0.02/sqrt(r), Q = 10, 5 rounds) on the
# circulant torus over {"pod": 4, "data": 5}: 4 directions, w_self 1/5,
# 80 directed edges; the byte table is 80 edges x wires x 1,548 B (dense)
# or 396 B (top-64 bitmap: 3 chunks of 64 + 64 + 4), the intra-pod subset
# 40 edges, the backbone scope's 1,408-column wire at chunk 128 1,452 B
TORUS_AXES = {"pod": 4, "data": 5}
TORUS_RUNS = [  # (label, algorithm, schedule, topk, knobs)
    ("FD-DSGT sequential int8", "dsgt", "sequential", None, {}),
    ("FD-DSGT pipelined int8", "dsgt", "pipelined", None, {}),
    ("FD-DSGT top-64", "dsgt", "sequential", 64, {}),
    ("FD-DSGT node_churn int8", "dsgt", "sequential", None,
     {"topology_program": DYNAMIC_RUNS[0][3]}),
    ("FD-DSGT secure_agg int8", "dsgt", "sequential", None, {"privacy": "secure_agg"}),
    ("FD-DSGT backbone int8 chunk 128", "dsgt", "sequential", None,
     {"scope": "backbone", "scale_chunk": 128}),
    ("FD-DSGT axes_subset=data int8", "dsgt", "sequential", None, {"axes_subset": ("data",)}),
    ("FD-DSGD sequential int8", "dsgd", "sequential", None, {}),
]
TORUS_WIRE = {"FD-DSGT sequential int8": 247_680, "FD-DSGT pipelined int8": 247_680,
              "FD-DSGT top-64": 63_360, "FD-DSGT node_churn int8": 247_680,
              "FD-DSGT secure_agg int8": 247_680,
              "FD-DSGT backbone int8 chunk 128": 232_320,
              "FD-DSGT axes_subset=data int8": 123_840, "FD-DSGD sequential int8": 123_840}
# (c2) train_100m on sharded_fused: SmolLM-360M at full width and depth, a
# ring of 2 over the node axis, one FD-DSGT round (Q and alpha as phase 5)
LM_ARGS = ["--arch", "smollm-360m", "--nodes", "2", "--rounds", "1", "--q", str(TRAIN_Q),
           "--alpha0", str(TRAIN_ALPHA0), "--ckpt", ""]
LM_LOSS_RTOL = 1e-3


def _stage_kernel(algorithm: str, topk) -> str:
    return {(True, 1): "wire_stage_compact", (True, 2): "wire_stage_gt_compact",
            (False, 1): "wire_stage", (False, 2): "wire_stage_gt"}[
        (topk is not None, 2 if algorithm == "dsgt" else 1)]


def torus_paths(group, cpu_group) -> dict:
    """(c1) Each configuration through ``run_sharded_engine`` with
    ``w=None`` (the circulant torus over the group's node axes), 5
    rounds at Q = 10 on the one-rank NCCL group: ONE wire-stage launch a
    round and no round kernel; every torus edge is a local copy on one
    rank, so no message is sent; the table's wire bytes; against
    ``FusedEngine`` on the torus's dense equivalent on the card (the
    all-gather wire's rules, phase 3: params and tracker within 1e-5
    after one round on the dense wires, the loss within rtol 1e-3 every
    round and the consensus within 1e-3 after five; the top-64 wire on
    the loss alone: exact ties of the MLP's output columns) and against
    the same run on the host CPU's twins (the loss within rtol 1e-3, one
    round's params within 1e-5). ``secure_agg`` is also held bitwise to
    the plaintext run. Counts are zeroed before each run and read just
    after."""
    from repro_torch.core.mixing import mesh_gossip_dense_equivalent

    launches, plain = {}, None
    for label, algorithm, schedule, topk, knobs in TORUS_RUNS:
        knobs = dict(knobs)
        chunk = knobs.pop("scale_chunk", 512)
        subset = knobs.pop("axes_subset", None)
        dense = mesh_gossip_dense_equivalent(TORUS_AXES, axes_subset=subset)
        kernel = _stage_kernel(algorithm, topk)
        kw = dict(rounds=SHARDED_ROUNDS, q=10, algorithm=algorithm, topk=topk,
                  fl_schedule=schedule, scale_chunk=chunk, log=False, w=None,
                  axes_subset=subset, **knobs)
        zero_counts()
        t0 = time.perf_counter()
        out = run_sharded_engine(group, **kw)
        expect_launches(f"(c1) {label}", **{kernel: SHARDED_ROUNDS})
        run_s = time.perf_counter() - t0
        launches[kernel] = launches.get(kernel, 0) + SHARDED_ROUNDS
        eng = out["engine"]
        if (eng.torus is None or len(eng.dirs) != (2 if subset else 4)
                or eng.collectives or eng.collective_bytes
                or out["wire_bytes"] != TORUS_WIRE[label]
                or not np.array_equal(eng.dense_equivalent(), dense)):
            raise AssertionError(f"(c1) {label}: {eng.collectives} messages of "
                                 f"{eng.collective_bytes} B, wire {out['wire_bytes']} B/round")
        fused_axes = {k: v for k, v in knobs.items() if k != "privacy"}
        state, losses, _ = fused_oracle(algorithm, schedule, topk, scale_chunk=chunk, w=dense,
                                        **fused_axes)
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], losses))
        mean_diff = float((out["state"].params.mean(0) - state.params.mean(0)).abs().max())
        notes = [f"vs the fused engine on the dense equivalent: loss rel {rel:.2e}"]
        if not all(math.isfinite(v) for v in out["losses"]) or rel > 1e-3:
            raise AssertionError(f"(c1) {label} vs fused: loss rel {rel}: {out['losses']} vs "
                                 f"{losses}")
        if topk is None:
            zero_counts()
            one = run_sharded_engine(group, **dict(kw, rounds=1))["state"]
            expect_launches(f"(c1) {label}, one round", **{kernel: 1})
            launches[kernel] += 1
            want, _, _ = fused_oracle(algorithm, schedule, None, rounds=1, scale_chunk=chunk,
                                      w=dense, **fused_axes)
            diff1 = float((one.params - want.params).abs().max())
            if algorithm == "dsgt":
                diff1 = max(diff1, float((one.tracker - want.tracker).abs().max()))
            if diff1 > 1e-5 or mean_diff > 1e-3:
                raise AssertionError(f"(c1) {label} vs fused: params/tracker {diff1} after "
                                     f"one round, consensus {mean_diff} after five")
            notes.append(f"one round's params/tracker {diff1:.2e}, consensus after five "
                         f"{mean_diff:.2e}")
            cpu_one = run_sharded_engine(cpu_group, **dict(kw, rounds=1))["state"]
            cdiff = float((one.params.cpu() - cpu_one.params).abs().max())
            if cdiff > 1e-5:
                raise AssertionError(f"(c1) {label}: one round's params off the CPU's by "
                                     f"{cdiff}")
            notes.append(f"one round vs the CPU twins {cdiff:.2e}")
        cpu = run_sharded_engine(cpu_group, **kw)
        crel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], cpu["losses"]))
        if crel > 1e-3:
            raise AssertionError(f"(c1) {label}: loss rel {crel} off the CPU twins' run")
        notes.append(f"5 rounds vs the CPU twins: loss rel {crel:.2e}")
        if label == "FD-DSGT sequential int8":
            plain = out["state"]
        if knobs.get("privacy") == "secure_agg":
            if not (torch.equal(out["state"].params, plain.params)
                    and torch.equal(out["state"].tracker, plain.tracker)):
                raise AssertionError("(c1) secure_agg: params not bitwise the plaintext run's")
            notes.append("params and tracker bitwise the plaintext run's")
        log(f"  (c1) {label}, {SHARDED_ROUNDS} rounds x Q=10 on the {TORUS_AXES} torus "
            f"({len(eng.dirs)} directions, w_self {eng.torus.w_self:.4f}, {run_s:.2f} s): "
            f"{SHARDED_ROUNDS} {kernel} launches, {eng.wire_encoding} wire "
            f"{out['wire_bytes']:,.0f} B/round, 0 messages (every edge a local copy on one "
            f"rank); " + "; ".join(notes))
    return launches


def torus_profiles(card: str, group) -> dict:
    """(c3) Whole FD-DSGT Q = 10 rounds of the paper's configuration (int8
    wire) on the circulant torus beside the all-gather wire on the
    torus's dense equivalent, in the same call."""
    from repro_torch.core.mixing import mesh_gossip_dense_equivalent

    return {"torus int8": round_profile(card, engine="sharded_fused", group=group,
                                        mix_w=None),
            "all-gather int8 (torus W)": round_profile(
                card, engine="sharded_fused", group=group,
                mix_w=mesh_gossip_dense_equivalent(TORUS_AXES))}


def lm_torus_path(card: str) -> dict:
    """(c2) ``examples/train_100m.py --fl-engine sharded_fused --arch
    smollm-360m --nodes 2 --model-shards 1``: full width and depth, the
    ring of 2 over the node axis on a one-rank NCCL group (the one card),
    one FD-DSGT round -- its launches (one ``wire_stage_gt`` a round, the
    flash kernel twice a layer, node and step under remat), its host
    clock, a profiled extra round's busy share, peak memory; then
    the same command on ``--fl-engine fused`` (the ring's W is the
    torus's dense equivalent), whose losses the sharded run's must equal
    within 1e-3 relative."""
    from repro_torch.examples import train_100m

    cfg = get_config(TRAIN_ARCH)
    nodes, rounds, layers = 2, 1, cfg.n_layers
    flash = rounds * TRAIN_Q * nodes * layers * 2
    tmp = tempfile.mkdtemp()
    out = {}

    def after(group, result):
        expect_launches("(c2) train_100m sharded_fused", wire_stage_gt=rounds,
                        flash_attention=flash)
        peak = torch.cuda.max_memory_allocated() / 1e9
        times = round_times(result.history)
        step_ms = times[0] * 1e3  # one round, its first calls' warm-up included
        eng = result.engine
        fl = FLConfig(algorithm="dsgt", q=TRAIN_Q, n_nodes=nodes)
        round_fn = make_fl_round(build_model(cfg).loss_fn, inv_sqrt(TRAIN_ALPHA0), fl, eng)
        batch = next(make_fl_token_batches(cfg.vocab_size, nodes, 1, 128, q=TRAIN_Q, seed=9))
        # the rounds below hold one state at a time (a second would not fit
        # beside a round's temporaries)
        state, result.state = result.state, None

        def one():
            nonlocal state
            state, _ = round_fn(state, batch)

        prof = profile_device(one, 1, f"SmolLM-360M sharded_fused torus {nodes}-node",
                              "round", step_ms, card, tables=False)
        # (r2): one more round under op_analysis, which phase 9 holds
        # against the dry run's prediction for this configuration
        args = dryrun._bytes(state) + sum(v.nbytes for v in batch.values())
        gathers = eng.shard_gathers
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with op_analysis() as oa:
            state, _ = round_fn(state, batch)
        torch.cuda.synchronize()
        measured = {"costs": oa.costs(), "argument_bytes": args,
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "shard_gathers": eng.shard_gathers - gathers}
        return {"peak_gb": peak, "times": times, "round_ms": step_ms,
                "wire": eng.wire_bytes(fl), "dirs": len(eng.dirs),
                "messages": eng.collectives, "measured": measured, **prof}

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    rows, info = train_100m.main(LM_ARGS + [
        "--fl-engine", "sharded_fused", "--model-shards", "1",
        "--metrics", os.path.join(tmp, "sharded.csv")], after=after)
    sharded_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    fused_rows = train_100m.main(LM_ARGS + ["--fl-engine", "fused",
                                            "--metrics", os.path.join(tmp, "fused.csv")])
    expect_launches("(c2) train_100m fused", fused_round_gt=rounds, flash_attention=flash)
    fused_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in rows]
    fused_losses = [r["loss"] for r in fused_rows]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, fused_losses))
    if not all(math.isfinite(x) for x in losses) or rel > LM_LOSS_RTOL:
        raise AssertionError(f"(c2) SmolLM-360M sharded_fused losses {losses} vs fused "
                             f"{fused_losses} (rel {rel})")
    log(f"  (c2) SmolLM-360M ({cfg.param_count():,} params, {layers} layers) through "
        f"train_100m on sharded_fused, a ring of {nodes} ({info['dirs']} direction, "
        f"{info['messages']} messages: one rank), FD-DSGT Q={TRAIN_Q}, {rounds} round "
        f"({sharded_s:.1f} s): launches wire_stage_gt {rounds}, flash_attention {flash}; "
        f"wire {info['wire']:,.0f} B/round; losses {[round(x, 5) for x in losses]} vs "
        f"fused {[round(x, 5) for x in fused_losses]} ({fused_s:.1f} s; rel {rel:.2e}); "
        f"host clock of the round {info['round_ms']:.1f} ms (its first calls' warm-up "
        f"included); peak memory {info['peak_gb']:.2f} GB [{card}]")
    out["counts"] = {"wire_stage_gt": rounds, "fused_round_gt": rounds,
                     "flash_attention": 2 * flash}
    out["measured"] = info.pop("measured")
    out["row"] = {k: v for k, v in info.items() if k != "times"}
    return out


def torus_and_two_axis(card: str) -> dict:
    """Phase 8: (c1) and (c3) on a one-rank NCCL group over the
    {"pod": 4, "data": 5} node torus (and its host-CPU twin on gloo),
    then (c2), which starts its own group. Returns the launches."""
    launches = {}
    group = start_group(0, 1, os.path.join(tempfile.mkdtemp(), "store"), device="cuda",
                        node_axes=TORUS_AXES)
    try:
        cpu_group = NodeGroup(dist.new_group(backend="gloo"), 0, 1, torch.device("cpu"),
                              tuple(TORUS_AXES.items()))
        section("  -- (c1) the paper's configuration on the circulant torus")
        for name, count in torus_paths(group, cpu_group).items():
            launches[name] = launches.get(name, 0) + count
        section("  -- (c3) the torus round beside the all-gather round")
        rows = torus_profiles(card, group)
    finally:
        stop_group(group)
    section("  -- (c2) train_100m on sharded_fused: SmolLM-360M, a ring of 2")
    lm = lm_torus_path(card)
    for name, count in lm["counts"].items():
        launches[name] = launches.get(name, 0) + count
    return {"launches": launches, "rounds": rows, "lm": lm["row"], "measured": lm["measured"]}


# ---------------------------------------------------------------------------
# Phase 9: the dry run (r1) and its prediction held against the card (r2),
# beside tensor parallelism (p1)-(p4) on the card
# ---------------------------------------------------------------------------

# (r1) the reference's committed two-axis records, through the port's dry
# run on the card's host: train_4k, the single-pod mesh, sharded_fused on
# the two-axis layout, Q = 2
DRYRUN_ARCHS = ("tinyllama-1.1b", "dbrx-132b")
DRYRUN_FLAGS = ["--shape", "train_4k", "--mesh", "single", "--fl-engine", "sharded_fused",
                "--fl-shard-model", "--q", "2"]
DRYRUN_FIELDS = ("n_chips", "n_nodes", "model_params", "active_params")
# how the port's per-rank bytes differ from XLA's, buffer by buffer: the
# round counter (an int32 device scalar in the reference, a host int in
# the port); the metrics alpha, comm_rounds and wire_bytes (fp32 device
# scalars there, host floats here); XLA's output tuple table, 8 bytes a
# leaf for 18 leaves (step, params, tracker, prev_grad, six comm buffers,
# eight metrics)
DRYRUN_ARG_GAP = 4
DRYRUN_OUT_GAP = 4 + 3 * 4 + 18 * 8
# (r2) the dry run's prediction for (c2)'s configuration: SmolLM-360M, a
# ring of 2 nodes on one rank, Q = 2, S 128, batch 1 a node, chunk 256
PREDICT_FLAGS = ["--arch", TRAIN_ARCH, "--shape", "train_4k", "--fl-engine", "sharded_fused",
                 "--layout", "2/1/1", "--seq-len", "128", "--global-batch", "2",
                 "--q", str(TRAIN_Q), "--scale-chunk", "256"]


def _dryrun_cli(args: list) -> subprocess.Popen:
    """``python -m repro_torch.launch.dryrun`` in a process of its own (one
    fake process group a process), on the host's CPU."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _dryrun_record(proc: subprocess.Popen, what: str) -> dict:
    out, err = proc.communicate(timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"{what}: the dry run exited {proc.returncode}: {err[-2000:]}")
    return json.loads(out)


def start_dryruns() -> tuple:
    """Phase 9's dry runs, each a process of its own on the host: (r1) the
    reference's two records' pairs, (r2) the prediction."""
    return ({arch: _dryrun_cli(["--arch", arch, *DRYRUN_FLAGS]) for arch in DRYRUN_ARCHS},
            _dryrun_cli(PREDICT_FLAGS), time.perf_counter())


def dryrun_phase(measured: dict, started: tuple) -> None:
    """(r1) each committed reference record's hardware-independent fields
    from the port's dry run (which also proves the card's PyTorch has the
    ``fake`` process-group backend); (r2) the dry run's prediction for
    (c2)'s round against the round phase 8 ran on the card under
    ``op_analysis``: argument bytes, FLOPs, collectives by kind,
    ``shard_gathers`` and each kernel's launches equal; the peak beside
    ``torch.cuda.max_memory_allocated()``, reported. ``started``:
    :func:`start_dryruns`' processes."""
    procs, predict, t0 = started
    for arch, proc in procs.items():
        got = _dryrun_record(proc, f"(r1) {arch}")
        with open(os.path.join(ROOT, "experiments", "dryrun",
                               f"{arch}_train_4k_single_sharded_fused_shardmodel_q2.json")) as f:
            want = json.load(f)
        bad = [k for k in DRYRUN_FIELDS if got[k] != want[k]]
        if got["two_axis"] != want["two_axis"]:
            bad.append("two_axis")
        gaps = (want["memory"]["argument_bytes"] - got["memory"]["argument_bytes"],
                want["memory"]["output_bytes"] - got["memory"]["output_bytes"])
        if gaps != (DRYRUN_ARG_GAP, DRYRUN_OUT_GAP):
            bad.append(f"memory gaps {gaps}")
        if bad:
            raise AssertionError(f"(r1) {arch}: the dry run differs from the reference's "
                                 f"record in {bad}: {json.dumps(got)[:2000]}")
        two = got["two_axis"]
        log(f"  (r1) {arch}: {got['n_chips']} ranks, {got['n_nodes']} nodes, shard width "
            f"{two['shard_width']:,}, {two['pallas_calls']} wire-stage launch a tile, wire "
            f"{two['wire_bytes_per_shard_one_edge']:,} B an edge and "
            f"{two['wire_bytes_per_shard_per_round']:,.0f} B a round a shard on "
            f"{two['collective_axes']}; argument / output bytes "
            f"{got['memory']['argument_bytes']:,} / {got['memory']['output_bytes']:,} (the "
            f"reference's less {DRYRUN_ARG_GAP} / {DRYRUN_OUT_GAP} host-held bytes); "
            f"{got['flops']:.4e} FLOPs, peak {got['memory']['temp_bytes'] / 1e9:.1f} GB a "
            f"rank; traced in {got['trace_s']} s -- all equal the committed record")
    pred = _dryrun_record(predict, "(r2) prediction")
    costs = measured["costs"]
    rows = [
        ("argument bytes", pred["memory"]["argument_bytes"], measured["argument_bytes"]),
        ("FLOPs", pred["flops"], costs.flops),
        ("collectives", pred["collectives"]["per_kind"], costs.collectives),
        ("collective bytes", pred["collectives"]["total_bytes"], costs.collective_bytes),
        ("shard_gathers", pred["shard_gathers"], measured["shard_gathers"]),
        ("kernel launches", pred["kernel_calls"], costs.kernel_calls),
    ]
    for what, want, got in rows:
        log(f"  (r2) {what}: predicted {want} measured {got}")
        if want != got:
            raise AssertionError(f"(r2) {what}: the dry run predicted {want}, the card's "
                                 f"round measured {got}")
    peak = pred["memory"]["argument_bytes"] + pred["memory"]["temp_bytes"]
    log(f"  (r2) peak: predicted {peak / 1e9:.2f} GB (arguments + the live peak on meta), "
        f"torch.cuda.max_memory_allocated() over the round {measured['peak_bytes'] / 1e9:.2f} "
        f"GB, ratio {measured['peak_bytes'] / peak:.3f} (reported, not gated); the dry "
        f"runs' processes {time.perf_counter() - t0:.1f} s")


# phase 9's tensor parallelism: the layers on a model group of two
# processes sharing the card over gloo (NCCL refuses two ranks on one
# device), batch 8, S 128, bf16 compute. The dense family: SmolLM-360M at
# full width and depth, (p1) its lm_loss, (p2) one Q = 1 tree round on 2
# nodes x 2 shards. Expert-parallel MoE and the VLM stack at full width and
# one layer (the group's shards and then the whole model fit one 80 GB
# card in fp32: 17.1 and 6.1 GB whole): (p3) llama4-scout-17b-a16e's
# lm_loss (16 experts of d_ff 8,192, a shared expert, vocab 202,240, 40 / 8
# heads); (p4) internvl2-26b's lm_loss with its 1,024 prefix embeddings
# before the 128 text tokens. Neither arch's tree round at full width fits
# one card, even at one layer: a 2-node round holds params, tracker,
# previous gradient and gradient and packs each tree into one buffer to mix
# it (InternVL2's whole-model round ran out of memory on an H100 80GB at 72
# GB allocated: the vocab tables are 4.6 of its 6.1 GB a node); the CPU
# tests and the dry run hold those rounds. The recurrent and audio families
# at full width, cut in depth (whole in fp32: about 3.8, 6.3 and 0.6 GB):
# (p5) rwkv6-7b, 2 layers, fp32 compute (its gradients are held at fp32:
# in bf16 they are ill-conditioned, ROADMAP.md queue 3), the WKV-6 kernel
# on the rank's 32 of 64 heads; (p6) recurrentgemma-2b, one period
# (recurrent, recurrent, local_attention), bf16, the RG-LRU scan on the
# rank's 1,280 of 2,560 channels and flash on the rank's 5 q heads (its one
# kv head cut: tp_head_plan's gather); (p7) whisper-medium, 2 encoder and
# 2 decoder layers over 1,500 frames, bf16, flash on the rank's 8 of 16
# heads in the encoder, the decoder's self- and cross-attention
TP_ARCH, TP_SHARDS, TP_BATCH, TP_SEQ = "smollm-360m", 2, 8, 128
TP_MOE_ARCH, TP_VLM_ARCH, TP_DEPTH = "llama4-scout-17b-a16e", "internvl2-26b", 1
#: (label, arch, depth, compute dtype) of the recurrent and audio cells
TP_RECURRENT = (("(p5)", "rwkv6-7b", 2, "float32"), ("(p6)", "recurrentgemma-2b", 3, ""),
                ("(p7)", "whisper-medium", 2, ""))
TP_FLAGS = ["--arch", TP_ARCH, f"{TP_MOE_ARCH}:{TP_DEPTH}", f"{TP_VLM_ARCH}:{TP_DEPTH}",
            *(f"{arch}:{depth}:{dtype}" for _, arch, depth, dtype in TP_RECURRENT),
            "--shards", str(TP_SHARDS), "--backend", "gloo", "--compute-dtype", "bfloat16",
            "--batch", str(TP_BATCH), "--seq-len", str(TP_SEQ)]
# the card's bf16 tolerances (PERF.md section 2): a loss within 1e-2
# relative, gradients within 5e-2 of each leaf's scale; the round's
# parameter updates and metrics as the gradients; a bf16 routing choice
# may differ from the whole model's only on a near-tie (ZOO_TIE_MARGIN)
TP_LOSS_RTOL, TP_GRAD_TOL = 1e-2, 5e-2
# fp32 compute ((p5)): the loss within 1e-5 relative, the gradients within
# 1e-2 of each leaf's scale. RWKV6's fp32 gradients are ill-conditioned (a
# head's first output is the rank-one bonus, which its RMS norm divides
# by): at 2 layers of full width the group's gradients sat 3.6e-3 of their
# scale from the whole model's (an H100 80GB HBM3 at 700 W), which the
# cell prints beside the whole model's own change when its embedding moves
# by one ulp (``lm_case(ulp=True)``)
TP_FP32_LOSS_RTOL, TP_FP32_GRAD_TOL = 1e-5, 1e-2


def _gb(peaks: list) -> str:
    return " / ".join(f"{p / 1e9:.1f}" for p in peaks) + " GB"


def check_tp_lm(label: str, arch: str, lm: dict, fp32: bool = False) -> dict:
    """One ``lm_case`` of the group against the whole model: the loss, the
    reassembled gradients (at bf16's tolerances, or fp32's), the
    replicated leaves bitwise equal on both ranks, the collectives against
    ``expected_collectives``, each kernel's launches a rank against
    ``expected_launches`` (flash 2 an attention layer under remat, WKV-6 2
    an RWKV6 layer, the RG-LRU scan 2 a recurrent block; whisper's
    encoder 1 a layer) and, for an MoE, the routing (the same on both
    ranks; a choice unlike the whole model's own only on a near-tie; the
    whole model takes the group's choices, so the loss and gradients
    compare the layers). Returns each kernel's launches, both ranks'."""
    layers = lm["layers"]
    loss_tol, grad_tol = (TP_FP32_LOSS_RTOL, TP_FP32_GRAD_TOL) if fp32 else (TP_LOSS_RTOL,
                                                                             TP_GRAD_TOL)
    rel = abs(lm["loss"] - lm["whole_loss"]) / abs(lm["whole_loss"])
    routing = lm["routing"]
    errs = lm["grad_errs"]
    worst = max(errs, key=errs.get)
    log(f"  {label} {arch}, {layers} layer(s), lm_loss on {TP_SHARDS} ranks: {lm['loss']:.6f} "
        f"vs the whole model's {lm['whole_loss']:.6f} (rel {rel:.2e}); gradients "
        f"reassembled from the shards within {errs[worst]:.2e} of their scale "
        f"(worst {worst}); replicated leaves bitwise equal on both ranks: "
        f"{lm['replicated_equal']}"
        + (f"; the whole model's gradients move {lm['ulp_response']:.2e} of their scale "
           "when its embedding moves by one ulp" if "ulp_response" in lm else ""))
    launched = {k: v for k, v in lm["launches"].items() if any(v)}
    want = {k: [n] * TP_SHARDS for k, n in lm["expected_launches"].items() if n}
    log(f"  {label} model group: {lm['counts']} (expected {lm['expected']}); launches a "
        f"rank {launched} (expected {want}); "
        f"{lm['tp_s']:.2f} s on the group, {lm['whole_s']:.2f} s whole; peak a process "
        f"{_gb(lm['peak_bytes'])} [{card_line()}]")
    if rel > loss_tol or errs[worst] > grad_tol:
        raise AssertionError(f"{label} the tensor-parallel loss or gradients drift from the "
                             f"whole model's: {lm}")
    if not lm["replicated_equal"]:
        raise AssertionError(f"{label} a replicated leaf's gradient differs across the ranks")
    if lm["counts"] != {k: v for k, v in lm["expected"].items() if v}:
        raise AssertionError(f"{label} model group collectives {lm['counts']}, expected "
                             f"{lm['expected']}")
    if launched != want:
        raise AssertionError(f"{label} launches {launched}, expected {want}")
    if routing is not None:
        flips = routing["flip_margins"]
        log(f"  {label} routing: {routing['calls']} calls the same on both ranks: "
            f"{routing['ranks_equal']}; {routing['matching']}/{routing['choices']} "
            f"token-expert choices match the whole model's; "
            + (f"{len(flips)} flipped token(s), top-k margins "
               f"{[round(m, 6) for m in flips[:8]]}" if flips else "no flip"))
        if not routing["ranks_equal"] or (flips and max(flips) >= ZOO_TIE_MARGIN):
            raise AssertionError(f"{label} routing: {routing}")
    return {k: sum(v) for k, v in launched.items()}


def check_tp_round(label: str, arch: str, rnd: dict) -> dict:
    """One ``round_case`` of the group against the whole-model round: the
    metrics' and the parameter updates' gaps, the replicated leaves, the
    flash launches (2 a layer, node and step). Returns the flash launches,
    both ranks'."""
    layers = rnd["layers"]
    m, w = rnd["metrics"], rnd["whole_metrics"]
    gaps = {k: abs(m[k] - w[k]) / abs(w[k]) for k in ("loss", "grad_norm_sq",
                                                       "consensus_err")}
    upd = max(rnd["update_errs"].values())
    log(f"  {label} {arch} tree round, 2 nodes x {TP_SHARDS} shards, Q 1: loss "
        f"{m['loss']:.6f} vs {w['loss']:.6f}, relative gaps "
        f"{json.dumps({k: float(f'{v:.2e}') for k, v in gaps.items()})}, parameter updates "
        f"within {upd:.2e} of their scale; flash launches a rank "
        f"{rnd['launches']['flash_attention']} "
        f"(2 x {layers} x 2 nodes); {rnd['tp_s']:.2f} s on the group, {rnd['whole_s']:.2f} "
        f"s whole; peak a process {_gb(rnd['peak_bytes'])} [{card_line()}]")
    if max(gaps.values()) > TP_GRAD_TOL or upd > TP_GRAD_TOL or not rnd["replicated_equal"]:
        raise AssertionError(f"{label} the tensor-parallel tree round drifts from the whole "
                             f"model's: {rnd}")
    if rnd["launches"] != {"flash_attention": [4 * layers] * TP_SHARDS,
                           "wkv6": [0] * TP_SHARDS, "rglru_scan": [0] * TP_SHARDS}:
        raise AssertionError(f"{label} launches {rnd['launches']}, expected "
                             f"{4 * layers} flash a rank")
    return {"flash_attention": sum(rnd["launches"]["flash_attention"])}


def tensor_parallel_phase() -> dict:
    """(p1)-(p7) in one ``benchmarks/tensor_parallel`` process, whose two
    ranks are spawned processes on the card: each holds its shard (drawn
    whole from one seed on the card, then cut) and runs the
    tensor-parallel path, then the whole model runs alone. Returns each
    kernel's launches, both ranks'."""
    torch.cuda.empty_cache()
    log(f"  this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB of the card "
        f"({torch.cuda.memory_reserved() / 1e9:.2f} GB reserved) beside the group")
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.tensor_parallel",
                           *TP_FLAGS], env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"the model group exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    cells = [check_tp_lm("(p1)", TP_ARCH, res[TP_ARCH]["lm"]),
             check_tp_round("(p2)", TP_ARCH, res[TP_ARCH]["round"]),
             check_tp_lm("(p3)", TP_MOE_ARCH, res[TP_MOE_ARCH]["lm"]),
             check_tp_lm("(p4)", TP_VLM_ARCH, res[TP_VLM_ARCH]["lm"])]
    cells += [check_tp_lm(label, arch, res[arch]["lm"], fp32=dtype == "float32")
              for label, arch, _, dtype in TP_RECURRENT]
    launches = {}
    for cell in cells:
        for name, count in cell.items():
            launches[name] = launches.get(name, 0) + count
    log(f"  tensor parallelism: {time.perf_counter() - t0:.1f} s (the group's own "
        f"{res['seconds']:.1f} s)")
    return launches


def ptxas_summary(lib) -> str:
    """One line of a library's ``-Xptxas -v`` report: kernels, registers,
    the most spilled and the most shared memory of any kernel."""
    text = lib.with_suffix(".log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(r) for r in re.findall(r"(\d+) bytes spill stores", text)]
    smem = [int(r) for r in re.findall(r"(\d+) bytes smem", text)] or [0]
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, spill stores up "
            f"to {max(spills)} B, static shared memory up to {max(smem)} B")


# the libraries whose every kernel's registers and spills phase 1 prints
PTXAS_DETAIL = ("fused_round_cluster", "wire_stage_compact", "flash_attention_tc",
                "decode_attention", "rwkv6_scan", "rglru_scan", "round_mix")


def ptxas_kernels(lib) -> list:
    """Each kernel of a library's ``-Xptxas -v`` report: (name, registers,
    spill store bytes, spill load bytes), the name demangled where
    ``c++filt`` is at hand."""
    rows = []
    for block in lib.with_suffix(".log").read_text().split("Compiling entry function")[1:]:
        name = re.search(r"'(\S+)'", block).group(1)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        rows.append([name, int(regs.group(1)) if regs else -1,
                     *(int(x) for x in (spill.groups() if spill else (-1, -1)))])
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=30).stdout.split("\n")
        for row, name in zip(rows, names):
            row[0] = re.sub(r"\(.*", "", name.replace("(anonymous namespace)::", "")) or row[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return [tuple(r) for r in rows]


def host_references() -> dict:
    """The host-CPU runs that need no kernel and nothing from the card:
    Fig. 2 at the paper's 3000 iterations (phase 3) and (d)'s Theorem 1
    and ablation drivers (phase 7). ``main`` runs them while ``nvcc``
    builds the kernels."""
    t0 = time.perf_counter()
    out = {"fig2": fig2_run(iterations=FIG2_ITERATIONS, device="cpu", log=False)}
    t1 = time.perf_counter()
    out.update(thm1=thm1_speedup.run(150, 2, device="cpu", log=False),
               ablations=ablations.run(device="cpu", log=False))
    out.update(fig2_s=t1 - t0, drivers_s=time.perf_counter() - t1)
    return out


# the intra-op threads of the host references' process: the card's
# process keeps the other cores of the card machine's 8
HOST_REF_THREADS = 5


def phase3_host() -> dict:
    """The host CPU's halves of phase 3's comparisons, which need nothing
    of the card: (h) each run's realized W_off replayed by the sharded
    engine on a one-rank gloo group, and ``slow_uplink``'s run there; (i)
    the dp runs on the CPU twins; (L1) the two 256-hospital runs and the
    gossip stage; (s1) the personalization driver; (s2) / (s3) the scoped
    runs. Keyed by path and run, each value what the card half compares."""
    out = {}
    group = start_group(0, 1, os.path.join(tempfile.mkdtemp(), "store"), device="cpu")
    try:
        for label, algorithm, schedule, topk, axes in SHARDED_DYNAMIC_RUNS:
            eng, _ = ShardedFusedEngine.from_group(
                group, stack_for_nodes(mlp_init(0, device="cpu"), 20),
                w=mixing_matrix("hospital20", 20), scale_chunk=512, topk=topk,
                round_schedule=schedule, **axes)
            out[label] = {"w": program_w_offs(eng, SHARDED_ROUNDS)[0]}
            if axes.get("node_program", "").startswith("slow_uplink"):
                run = run_sharded_engine(group, rounds=SHARDED_ROUNDS, q=10,
                                         algorithm=algorithm, topk=topk,
                                         fl_schedule=schedule, log=False, **axes)
                out[label].update(losses=run["losses"], effective=float(
                    run["metrics"]["wire_bytes_effective"]))
    finally:
        stop_group(group)
    out[("(i)", "dsgt")] = run_fused_engine(rounds=SHARDED_ROUNDS, q=10, privacy=DP_SPEC,
                                            device="cpu")["losses"]
    out[("(i)", "dsgd")] = fused_oracle("dsgd", "sequential", None, SHARDED_ROUNDS,
                                        device="cpu", privacy=DP_SPEC)[1]
    data = generate_ehr_cohort(seed=0, n_hospitals=LARGE_HOSPITALS)
    for algorithm in ("dsgt", "dsgd"):
        res = large_federation_train(algorithm, "cpu", data)
        out[("(L1)", algorithm)] = (list(res.history.column("loss")),
                                    _bal_acc(res.consensus, data))
    out[("(L1)", "gossip")] = large_gossip_errs("cpu")
    out["(s1)"] = personalization_ehr.run(PERSONALIZATION_ROUNDS, 10, device="cpu",
                                          init_params=mlp_init(0, device="cpu"),
                                          log=False)["rows"]
    for algorithm in ("dsgd", "dsgt"):
        for schedule, privacy in SCOPE_RUNS:
            out[("(s2)", algorithm, schedule, privacy)] = scoped_run(
                "cpu", algorithm, schedule, "backbone", privacy=privacy)[3]
    out["(s3)"] = scoped_run("cpu", "dsgt", "sequential", "layerwise:freq=4", rounds=8)[3]
    return out


def _host_references_process(requests, replies) -> None:
    """The host references' process, at a lower priority than the card's
    process (it would otherwise slow phases 2-3). First phase 3's host
    halves (:func:`phase3_host`), handed over as ``("phase3", them)``;
    then the host CPU's halves of (t1), (z2) and (z3), kept here, then
    ``("host", seconds of each)``; then, for each request ``"t1"``, ``"z2"`` or ``"z3"`` (the
    card's process waiting meanwhile), that path's card half and its
    comparisons, and ``(name, its launches)``. A failure replies ``(name,
    None, the traceback)``; None ends it."""
    os.nice(10)
    torch.set_num_threads(HOST_REF_THREADS)
    host, seconds = {}, {}
    jobs = ([(("t1", arch), t1_host, (arch, depth, dtypes))
             for arch, depth, dtypes in GRAD_MODELS]
            + [(("z2", arch), z2_host, (arch,)) for arch in ZOO_CPU]
            + [(("z3", arch), z3_host, (arch,)) for arch in ZOO_GRAD])
    name = "phase3"
    try:
        t0 = time.perf_counter()
        p3 = phase3_host()
        seconds["phase 3's references"] = time.perf_counter() - t0
        replies.put((name, p3, None))
        name = "host"
        for key, fn, args in jobs:
            t0 = time.perf_counter()
            host[key] = fn(*args)
            seconds[" ".join(key)] = time.perf_counter() - t0
        replies.put((name, seconds, None))
        while (name := requests.get()) is not None:
            replies.put((name, _card_half(name, host), None))
            torch.cuda.empty_cache()
    except Exception:  # handed to the card's process, which raises it
        replies.put((name, None, traceback.format_exc()))


def _card_half(name: str, host: dict) -> dict:
    """The card half of (t1), (z2) or (z3) against ``host``; its launches."""
    if name == "t1":
        return model_grad_paths(host)
    counts = {}
    if name == "z2":
        for arch in ZOO_CPU:
            zoo_card_vs_cpu(arch, host)
        return counts
    for arch in ZOO_GRAD:
        for kernel, count in zoo_grad_path(arch, host).items():
            counts[kernel] = counts.get(kernel, 0) + count
    return counts


class HostReferences:
    """The host CPU's references in a process of their own, beside phases
    2 and 3: phase 3's (:func:`phase3_host`, handed over when phase 3
    asks, :meth:`phase3`), then the host halves of (t1), (z2) and (z3)
    (they need no kernel: the same seeded weights -- drawn by the card's
    generator a leaf at a time and moved to the host -- and the same
    tokens), whose card halves and comparisons run in the process when
    phases 5 and 6 ask for them (:meth:`run`). ``wait`` before phase 4
    keeps the host halves out of its timings."""

    def __init__(self):
        ctx = torch.multiprocessing.get_context("spawn")
        self._requests, self._replies = ctx.Queue(), ctx.Queue()
        self._proc = ctx.Process(target=_host_references_process,
                                 args=(self._requests, self._replies), daemon=True)
        self._proc.start()
        self.seconds = {}

    def _reply(self, name: str):
        while True:
            try:
                got, out, error = self._replies.get(timeout=5)
                break
            except queue.Empty:
                if not self._proc.is_alive():
                    raise AssertionError(f"the host references' process ended "
                                         f"({self._proc.exitcode}) before {name!r}")
        if out is None or got != name:
            raise AssertionError(f"the host references' {got}:\n{error}")
        return out

    def phase3(self) -> tuple:
        """Phase 3's host halves (:func:`phase3_host`) and the seconds
        waited for them."""
        t0 = time.perf_counter()
        return self._reply("phase3"), time.perf_counter() - t0

    def wait(self) -> float:
        """The host halves' end; the seconds waited."""
        t0 = time.perf_counter()
        self.seconds = self._reply("host")
        return time.perf_counter() - t0

    def run(self, name: str) -> dict:
        """``name``'s card half and comparisons in the process (this one
        hands its cached card memory back first); their launches."""
        torch.cuda.empty_cache()
        self._requests.put(name)
        return self._reply(name)

    def close(self) -> None:
        self._requests.put(None)
        self._proc.join(timeout=120)


def timed(fn):
    t0 = time.perf_counter()
    return fn(), time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    phase("phase 1: build")
    with ThreadPoolExecutor(max_workers=1) as pool:
        building = pool.submit(timed, kbuild.build_all)
        host = host_references()
        libs, build_s = building.result()
    log(f"  built {sorted(name for _, name in libs)} in {build_s:.1f} s; meanwhile the "
        f"host CPU ran Fig. 2 ({host['fig2_s']:.1f} s) and the drivers of (d) "
        f"({host['drivers_s']:.1f} s)")
    for (_, name), lib in sorted(libs.items()):
        log(f"    ptxas {name}: {ptxas_summary(lib)}")
        if name in PTXAS_DETAIL:
            for kernel, regs, spill_st, spill_ld in ptxas_kernels(lib):
                log(f"      {kernel}: {regs} registers, spill stores {spill_st} B, "
                    f"spill loads {spill_ld} B")

    phase("phase 2: kernels vs twins on the card")
    refs = HostReferences()
    max_err = {**check_gossip_mix(), **check_kernels(), **check_wire_stages(),
               **check_compact_stages(), **check_attention_kernels(),
               **check_scan_kernels()}
    check_dp_epilogue()
    section("  -- the two-pass route past the one-pass plan")
    max_err.update(check_two_pass())

    phase("phase 3: paths (launches counted per run)")
    launches = main_path()
    fp32_runs = launches.pop("fp32_runs")
    launches.update(stale_paths(launches.pop("sequential_losses"), fp32_runs))
    section("  -- Fig. 2 and the compressed path")
    fig2_path(host)
    launches.update(compressed_path())
    section("  -- the dynamic rounds (topology and node programs)")
    for name, count in dynamic_paths().items():
        launches[name] += count
    section("  -- the staleness, churn and straggler drivers")
    driver_paths()
    section("  -- the sharded engine on a one-rank NCCL group")
    group = start_group(0, 1, os.path.join(tempfile.mkdtemp(), "store"), device="cuda")
    launches.update(sharded_path(group))
    sharded_quadratic(group)
    section("  -- the sharded dynamic round (h) and the privacy axis (i)-(k)")
    cpu, waited = refs.phase3()
    log(f"  phase 3's host references came from the host references' process (waited "
        f"{waited:.1f} s)")
    cpu_group = NodeGroup(dist.new_group(backend="gloo"), 0, 1, torch.device("cpu"))
    for counts in (sharded_dynamic_path(group, cpu), privacy_fused_path(cpu),
                   privacy_driver_path(), sharded_dp_path(group)):
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
    section("  -- (L1) a federation past the one-pass plan, (L2) item 9's knobs")
    for counts in (large_federation_path(cpu), wire_knob_paths(group, cpu_group)):
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
    section("  -- the federation scope (s1)-(s4), checkpoints and snapshots")
    for counts in (scope_paths(group, cpu), checkpoint_paths(group),
                   snapshot_serving_path()):
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
    section("  -- serving SmolLM-360M")
    serve = serving_path()
    for name in ("decode_attention", "flash_attention", "decode_attention_combine"):
        launches[name] = launches.get(name, 0) + serve[name]
    recurrent = {}
    for arch in RECURRENT_ARCHS:
        section(f"  -- {arch}")
        recurrent[arch] = recurrent_serving_path(arch)
    launches.update(wkv6=recurrent["rwkv6-7b"]["wkv6"],
                    rglru_scan=recurrent["recurrentgemma-2b"]["rglru_scan"])

    phase("phase 4: times (CUDA events, median of 60 after warm-up)")
    waited = refs.wait()
    log(f"  the host CPU's references of (t1), (z2), (z3) ran in a process beside phases "
        f"2-3 ({HOST_REF_THREADS} threads): "
        + ", ".join(f"{key} {sec:.1f} s" for key, sec in refs.seconds.items())
        + f"; phase 4 waited {waited:.1f} s for them")
    floor_ms = kb.launch_floor(card)
    section("  -- round kernels and round profiles")
    rows = timings(card, floor_ms)
    compact = compact_timings(card, group, floor_ms)
    rows["rounds"].update(compact.pop("rounds"))
    rows.update(compact)
    rows["rounds"].update(axis_timings(card, group))
    rows["rounds"].update(scope_timings(card))
    stop_group(group)
    section("  -- the two-pass route at 1,024 nodes")
    rows.update(two_pass_timings(card))
    section("  -- attention and scan kernels")
    rows.update(attention_timings(card))
    rows.update(scan_timings(card, floor_ms))
    section("  -- decode step profiles")
    rows["serving"] = decode_step_profile(card, serve["engine"],
                                          serve["prompts"][:, :PROFILE_PROMPT], SERVE_ARCH)
    del serve
    torch.cuda.empty_cache()
    for arch in RECURRENT_ARCHS:
        rows[arch] = recurrent_step_profile(card, arch)

    phase("phase 5: training the transformer (launches counted per run)")
    section("  -- (t1) gradients on the card")
    for name, err in check_kernel_grads().items():
        log(f"  {name}: gradient max err {err:.3e} of scale against autograd through "
            "its twin")
    train = training_counts(card, refs)
    for name, count in train.pop("counts").items():
        launches[name] = launches.get(name, 0) + count

    kernels = []
    for name, (_, _, _, replaces, source) in ALL_KERNELS.items():
        row = rows[(name, "main")]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
        })
        if name == "fused_round_gt":  # at the fused training run's (2, 361.8M)
            kernels[-1]["training_shape"] = train["rows"]["fused_round_gt"]
        if name in ROUND_WRAPPERS:  # the two-pass route past the one-pass plan
            label, wire = kb.FEDERATION[0], kb.ROUTE_WIRES[name][0].__name__
            route = rows[(name, f"{label} route")]
            kernels[-1]["two_pass"] = {
                "wire_stage": wire, "mix": "round_mix", "shape": list(kb.FEDERATION[1:3]),
                "route_ms": route["ms"], "plain_ms": route["plain_ms"],
                "bound_ms": route["bound_ms"], "bound_by": route["bound_by"],
                "wire_ms": rows[(wire, f"{label} {name}")]["ms"],
                "mix_ms": rows[("round_mix", f"{label} {name}")]["ms"]}
    # the two-pass route's mix kernel, part of rows 1-3: launched by (L1)'s
    # paths (their rounds refuse the one-pass plan), timed at the
    # 1,024-node federation's DSGT round
    row = rows[("round_mix", f"{kb.FEDERATION[0]} fused_round_gt")]
    kernels.append({
        "name": "round_mix", "route": "cuda", "source": kb.CSRC + "round_mix.cu",
        "replaces": "src/repro/kernels/gossip/gossip.py:199",
        "part_of": sorted(ROUND_WRAPPERS), "launches": launches["round_mix"],
        "max_abs_err": max_err["round_mix"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "bound_share": row["bound_ms"] / row["ms"],
    })
    # the gossip stage's two-pass wire stage, part of row 3: launched by
    # (L1)'s gossip path, timed at the 1,024-node federation (no int8
    # store, as the route runs it)
    row = rows[("wire_stage_gossip", f"{kb.FEDERATION[0]} gossip_mix")]
    kernels.append({
        "name": "wire_stage_gossip", "route": "cuda", "source": kb.CSRC + "wire_stage.cu",
        "replaces": "src/repro/kernels/gossip/gossip.py:378",
        "part_of": ["gossip_mix"], "launches": launches["wire_stage_gossip"],
        "max_abs_err": max_err["wire_stage_gossip"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
    })
    for name, (_, _, _, replaces, source) in COMPACT_KERNELS.items():
        row = rows[(name, "main")]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
        })
    for name, (replaces, source) in ATTENTION_KERNELS.items():
        row = rows[(name, "path")]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    # decode's second kernel, part of decode_attention: it runs only on a
    # cache of more than 4,096 slots, so the serving paths launch it no
    # time (their count, 0, is held by expect_launches); timed at the
    # large shape's partials
    row = rows[("decode_attention_combine", "large")]
    decode_row = next(k for k in kernels if k["name"] == "decode_attention")
    decode_row["parts"] = [{
        "name": "decode_attention_combine", "route": "cuda",
        "source": ATTENTION_KERNELS["decode_attention"][1],
        "replaces": ATTENTION_KERNELS["decode_attention"][0],
        "launches": launches["decode_attention_combine"],
        "max_abs_err": max_err["decode_attention_combine"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
    }]
    for name, (replaces, source) in SCAN_KERNELS.items():
        row = rows[(name, "path decode")]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
        })
    phase("phase 6: the model zoo (launches counted per run)")
    zoo = model_zoo(card, refs)
    for name, count in zoo["counts"].items():
        launches[name] = launches.get(name, 0) + count
    zoo_times = zoo["rows"].pop("times")
    for row in kernels:
        if row["name"] in ("decode_attention", "flash_attention"):
            row["launches"] = launches[row["name"]]
            row["zoo_shapes"] = [{"shape": label, **times}
                                 for (name, label), times in zoo_times.items()
                                 if name == row["name"]]

    phase("phase 7: bf16 flat storage and the standalone drivers (launches counted per run)")
    for name, count in bf16_and_drivers(card, host, fp32_runs, rows["rounds"]).items():
        launches[name] = launches.get(name, 0) + count

    phase("phase 8: the circulant torus wire and the two-axis layout (launches counted "
            "per run)")
    torus = torus_and_two_axis(card)
    for name, count in torus["launches"].items():
        launches[name] = launches.get(name, 0) + count
    phase("phase 9: the dry run (r1), (r2) on the host beside tensor parallelism (p1)-(p7) "
          "on a model group of two ranks sharing the card (launches counted per rank)")
    dryruns = start_dryruns()
    for name, count in tensor_parallel_phase().items():
        launches[name] = launches.get(name, 0) + count
    dryrun_phase(torus["measured"], dryruns)
    del torus
    phase(None)
    for row in kernels:
        row["launches"] = launches[row["name"]]

    section("all phases done")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
