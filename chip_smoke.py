"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases (the first that fails ends the run with a nonzero exit):

1. Print the card's name and power limit, build every CUDA kernel from
   the sources in the checkout (one nvcc per source, in parallel), and
   print ptxas's registers and spills for `spray_select`, `lt_encode`,
   `link_fold` and the `flash_attention` sources (a spill in the latter
   fails the run).
2. Hold each kernel against its plain PyTorch version on the card: the
   `spray_select` kernel over every spray method x ell x path count, at
   131,072 decisions, plus ragged batches, path counts above 128 (129,
   256, 1,000 and 20,000, which one pass of shared memory holds) and the
   main path's row shape; its row-base form (`spray_select_rows`) over
   every method x ell 8 / 10 / 16 x n 1 / 16 / 128 / 20,000, with row
   bases that wrap past 2**32, int64 and int32 inputs and 0-d seeds;
   one device operation a call for the sender's WAM branch and for
   `spray_paths` (`torch.profiler`); the `lt_encode` kernel over the
   reference tests' shapes, ragged shapes with negative and out-of-range
   indices, an unaligned payload (the word route), degree 200, rows of
   several column tiles, K = 1 and the full-width message (the vector
   route); the `link_fold` kernel over the fabric's link lists at depths
   1, 64 (the wide cell), 512, 8,192 (the fat-tree family's scenarios),
   32,768 (intra-pod traffic on a fat-tree's bypass link) and a ragged
   case with empty links, on float32 values of mixed signs and magnitudes;
   three CUDA-graph replays of each kernel, bit-equal.  Results must be
   equal; each kernel's time is printed beside the plain version's, and
   `spray_select`'s beside its main-path form, the WAM branch,
   `torch.searchsorted` and the card's launch floor, `link_fold`'s beside
   the launch floor, `index_add` and its bound (the deepest link's chain
   of dependent adds, or the bytes).
3. Run every case of `tests/golden/transport_seed.npz` and
   `transport_policies.npz` on the card and compare the five golden fields
   bit for bit.
4. Full width: `simulate_flows` with 4,096 flows on a 64-leaf, 16-spine
   fabric for WAM and ECMP; every flow must finish.  The WAM run is
   repeated with the spray held to its plain version: outputs must be
   identical.
5. The fat-tree family (benchmarks/bench_scaleout.py's full pass,
   unsharded): `sweep_flows_scenarios` over the four `fat_tree_scenarios`
   of 4,096 flows on 8 pods x 4 leaves x 2 spines x 2 cores (link capacity
   32, host rate 64, 4 packets a flow, early exit), ECMP and WAM, one
   draw, with telemetry (stride 16, window 128), horizon 1,024 (cut from
   the bench's 2,048: every flow finishes by tick 288, so the cct digest
   is the same; the two ECMP runs that never settle run 1,024 ticks
   fewer): every flow must finish; the ticks, ms a tick, cct percentiles
   and kernel launches of each run, the peak memory and the cct digest
   are printed.  WAM on `inter_pod_incast` without telemetry, and WAM on
   `core_link_flap` with the plain spray, must equal their slices.  Then
   the card against the
   CPU: `pair_scenarios(flows=4, horizon=256)` and a 64-flow fat-tree
   family (4 pods x 2 x 2 x 2, with one placement of intra- and inter-pod
   flows) through `sweep_flows_scenarios` with telemetry over ECMP, WAM and
   CC_COUPLED and two draws: every result field and frame leaf bit-equal.
6. The job and cluster layers: (a) `compile_job` for all 10 archs
   (workers 4, tp 8, iterations 2, rate 32, max_shard 512), each one's
   compute:comm ratio, shards and steps printed; (b) the job cell,
   benchmarks/bench_job_ettr.py's full pass for qwen3-8b: the six
   `job_scenarios(workers=4, horizon=2048)` stacked, ECMP and WAM at rate
   32, one draw, early exit in chunks of 16, through
   `sweep_job_steps_scenarios`: every step must finish and the cct digest
   equal the JAX package's (pinned, `JOB_DIGEST`); each (scenario,
   policy)'s ETTR, exposed ticks, ticks run, ms a tick and kernel
   launches, and the WAM - ECMP margin, are printed; (d) WAM on link_flap
   with the plain spray must equal its slice of (b) in every field of
   every step, and one job step runs under torch's sync debug mode
   "error"; (c) the cluster cell, benchmarks/bench_cluster.py's full pass
   for its rings_overlapped scenario (xlstm-350m and qwen3-8b, max_shard
   256, horizon 1,024; flap_during_overlap is cut to keep the script
   within eight minutes), ECMP and WAM,
   one draw, through `sweep_cluster`: every round must finish, the raw
   cct digest equal the reference's (`CLUSTER_DIGEST`), and per-job ETTR,
   solo ETTR, slowdown, Jain fairness, the hottest link's utilisation,
   ticks and ms a tick are printed; (e) the card against the CPU at the
   CPU tests' sizes: `sweep_job` over link_flap, crossjob_background and
   the correlated spine outage x ECMP, WAM, RAND_ADAPTIVE, CC_COUPLED x
   two draws, `run_job` with telemetry, `sweep_cluster_rounds_scenarios`
   over the overlapped and staggered placements padded to one round count
   and over the correlated burst flaps (its grid has another link count,
   so it is a call of its own), and `sweep_ring_cct_shared` on a ring of
   4: every result field and frame leaf bit-equal.
7. The coded path: one 32 MiB message (K = 8,192 source symbols of 4 KiB)
   encoded into R = 13,139 symbols on the card; decoding all of them and a
   seeded 90% subset, a K = 256 round trip and two `decode_overhead_curve`
   runs must equal the same calls on the CPU.  (The `lt_encode` kernel is
   held to its plain version in phase 2, at this shape among others.)
8. The serving router: 64 replicas of unequal weight, 200 windows of
   4,096 requests with one replica 8x slower in windows 50-119; every
   replica id, sequence number, severity weight and share must equal the
   router's CPU run.
9. Dense serving: (a) `smoke()` of qwen3-8b and of
   h2o-danube-3-4b on the card, held to the same run on the CPU (which
   the CPU tests hold to the JAX model); (b) full width: qwen3-8b, all 36
   layers, f32 weights from a seeded generator on the card, 4 prompts of
   2,048 tokens from ``default_rng(0)``, 64 greedy tokens, then the same
   run teacher-forced with the attention kernels' plain versions; logits
   and tokens must agree as closely as bf16 rounding through 36 layers
   allows (`FULL_RMS_TOL`, `FULL_MAX_TOL`); the prefill must launch
   `flash_attention` once a layer and the decode `flash_decode` once a
   layer a step, neither copying an operand.  Phase 2 holds
   `flash_attention` (both routes: bf16 on the wgmma / TMA kernel, f32 on
   the CUDA-core kernel, each case printed with its route and the
   wrapper's aligning copies) and `flash_decode` to their plain versions
   (the CPU tests' shapes, a head dim of 20, a misaligned view, key counts
   that are not a multiple of the key tile, the full-width prefill and
   decode shapes, and the zoo's: whisper's non-causal encoder (1,500
   frames, D 64) and cross-attention (384 queries over 1,500 keys),
   starcoder2's group of 12 with a 4,096 window over 8,192 keys, arctic's
   group of 7, decode over 1,500 full cross-attention slots at D 64 and at
   groups 6, 7 and 12; for `flash_decode` also empty rows, the output bit-equal
   to `normalise` of the partials, one launch a call, an int64 kv_len out
   of [0, Sk], the model's stacked-cache slice read in place, a view copied
   once, and three CUDA-graph replays of one call) and times them beside
   the plain versions and `scaled_dot_product_attention`.

10. The rest of the model zoo (phase `zoo`, within ~150 s): (a) the smoke
   configs of qwen1.5-4b, starcoder2-3b, dbrx-132b, arctic-480b,
   jamba-v0.1-52b, xlstm-350m, whisper-large-v3 and llava-next-mistral-7b,
   and qwen3-8b's with the int8 KV cache, on the card against the CPU, as
   in 9 (a) (patches and frames drawn from a seed; the MoE choices of the
   CPU run replayed on the card, `moe.Routes`), with caches and states and
   each run's launch counts; (b) jamba-v0.1-52b at its published widths
   cut to one period of 8 of its 32 layers (7 mamba, 1 attention, 4 MoE, 4
   MLP; ~27 GB of bf16 weights), 4 x 2,048 prompt tokens, 64 generated;
   (c) whisper-large-v3 whole (32 encoder and 32 decoder layers, d 1,280),
   1,500 frames, 4 x 384 prompt tokens, 64 generated; (b) and (c) as 9
   (b): prefill and decode times, peak memory and launches, then the plain
   versions' run teacher-forced on tokens and MoE choices within
   `FULL_RMS_TOL` / `FULL_MAX_TOL`.
11. Training (phase `train`): (a) every arch's smoke config, 3 steps of 4
   x 64 tokens (AdamW; Adafactor for arctic, dbrx and jamba) on the card
   against the same steps on the CPU, the CPU run's MoE choices replayed:
   losses within 2e-3 and step-1 gradients within 5e-2 relative L2 per
   leaf (jamba 0.1), the CPU tests' tolerances; `flash_attention` twice
   (remat) and `flash_attention_bwd` once an attention sublayer and
   encoder layer a step; xlstm-350m's and jamba's also at 4 x 128 tokens,
   two 64-step chunks of their scans (`TRAIN_LONG_GRAD_TOL`); (b) the trainer CLI (`--arch qwen3-8b --smoke
   --device cuda --steps 6 --ckpt-every 3`) under deterministic
   algorithms, straight and resumed from the step-3 checkpoint: the final
   checkpoints equal SHA1 for SHA1 (two runs without deterministic
   algorithms are compared too); (c) full width: qwen3-8b at its
   published widths cut to 4 of 36 layers, f32 weights drawn on the card
   from seed 0, `SyntheticLM` batches of 4 x 2,048 tokens, AdamW at the
   CLI's defaults, 4 steps: ms a step (steps 2-4), tokens/s, peak memory
   and the launches a step (8 forward, 4 backward, no copies); then the
   same steps with the plain attention and with the plain attention in
   float64 (the noise floor, as `scripts/dense_noise_floor.py --train`
   measures it): every step's loss and every leaf of the step-1 gradient
   of the kernels' run within `TRAIN_FLOOR_RATIO` times the floor of the
   plain run; (d) xlstm-350m whole at its published widths (24 layers, d
   1,024), f32 weights from seed 0, AdamW, one step of `SyntheticLM`
   batches of 8 x 256 tokens with the chunked scans (`ssm.chunked_scan`):
   ms a step, tokens/s, peak memory; then with the unchunked ones
   (`unchunked_scans`): losses and step-1 gradients bit-equal, and its
   peak beside the reckoned bytes of saved states (a step at 8 x 2,048
   tokens takes minutes: `scripts/profile_cells.py --cell train_xlstm`);
   no kernel runs (xlstm has no attention); (e) jamba-v0.1-52b at its
   published widths cut to the serving cell's period (8 of 32 layers, ~27
   GB of bf16 weights), Adafactor (the config's), batches of 2 x 2,048
   tokens, 2 steps: the numbers of (d), `flash_attention` with lse twice and
   `flash_attention_bwd` once a step, no copies; then the same steps with
   ``remat_policy="save_ffn"`` (losses and step-1 gradients bit-equal, its
   peak and ms a step), with the plain attention and with the plain
   attention in float64, the first run's MoE choices replayed: every loss
   and every leaf of the step-1 gradient of the kernels' run within
   `TRAIN_FLOOR_RATIO` times the floor, as in (c).  Phase 2 holds
   `flash_attention_bwd` (and the forward's lse) to the plain versions at
   the CPU tests' shapes, the train shape
   and the zoo's (whisper's encoder and cross-attention, starcoder2's
   4,096 window, arctic's group of 7, a group of 7 at D 20), two calls
   bit-equal, and times it at the train shape beside the plain backward
   and SDPA's backward (all graph-replayed; the kernel and SDPA eager
   too), with its launches' shares (delta, dK / dV, dQ) from
   `torch.profiler` and its design's 7-product floor beside the
   5-product bound.

12. The examples (phase `examples`, ~30 s): every
   `examples/torch_*.py` at the sizes its CPU tests run (the module's
   `SMOKE`), on the card and then on the CPU: the six network examples'
   `main` (quickstart, telemetry, topology scenarios, collective cct, job
   ETTR, cluster contention) return equal numbers (the telemetry exports
   byte-equal) and launch `spray_select` (and `link_fold` where they run
   the shared fabric) on the card; `serve_batched`'s `serve` on one set of
   smoke qwen3-8b weights drawn on the CPU, the card teacher-forced on the
   CPU's tokens, within `MODEL_TOL` (one `flash_attention` a layer in
   prefill, one `flash_decode` a layer a step); `train_tiny_lm`'s `train`
   from one set of weights, losses within `TRAIN_LOSS_TOL` (two
   `flash_attention` and one `flash_attention_bwd` a layer a step).
13. Flow-sharded runs (phase `shard`, after phase 6; ranks are threads of
   this process with private `torch.distributed` groups): (a) phase 5's
   fat-tree family without telemetry through `shard_sweep_flows_scenarios`
   over two gloo ranks sharing the card: every field equal to phase 5's
   unsharded result and the cct digest the reference's (`FAT_DIGEST`);
   (b) five flows, one of size 0 (the CPU tests' padded case), through
   `shard_run_flows` on one NCCL rank, equal to `run_flows_sized` on the
   card; (c) `sweep_job` and `sweep_cluster` with a mesh of two ranks on
   the card at the CPU tests' sizes, equal to the unsharded runs on the
   CPU.  Each part's seconds, ticks, ms a tick and launches are printed.

Each path of phases 4-13 runs with the kernels' launch counts set to 0
just before it and read just after; a kernel row's ``launches`` is its
total over those paths (the comparisons of phases 5, 6 and 13 not counted).  The
last lines are the card's name and power limit, one JSON object with a
row per kernel, and ``{"ok": true, "device": {...}}``.  Without a CUDA
device the script exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import random as prng  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.core.profile import make_profile, quantize_profile  # noqa: E402
from repro_torch.core.spray import (  # noqa: E402
    SprayMethod,
    SprayState,
    make_spray_state,
    spray_key,
    spray_paths,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    bwd_plan,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_attention_with_lse,
    plan,
)
from repro_torch.kernels.flash_decode import (  # noqa: E402
    flash_decode,
    flash_decode_plain,
    normalise,
)
from repro_torch.kernels.flash_decode import plan as decode_plan  # noqa: E402
from repro_torch.kernels.lt_encode import (  # noqa: E402
    as_int32_bits,
    lt_encode,
    lt_encode_plain,
)
from repro_torch.kernels.link_fold import link_fold, link_fold_plain, link_segments  # noqa: E402
from repro_torch.kernels.lt_encode import plan as lt_plan  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, host_batch  # noqa: E402
from repro_torch.launch.serve import generate, serve_batch  # noqa: E402
from repro_torch.launch.train import modality_stubs  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import kv_dequantize  # noqa: E402
from repro_torch.optim.api import make_optimizer  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402
from repro_torch.models.moe import Routes  # noqa: E402
from repro_torch.kernels.spray_select import (  # noqa: E402
    spray_select,
    spray_select_plain,
    spray_select_rows,
    spray_select_rows_plain,
)
from repro_torch.net import cluster, collectives, fountain, jobs  # noqa: E402
from repro_torch.net.fabric import FabricParams  # noqa: E402
from repro_torch.net.policies import Policy, assign_lanes  # noqa: E402
from repro_torch.net.policy_state import PolicyState  # noqa: E402
from repro_torch.net import sender  # noqa: E402
from repro_torch.net.scenarios import (  # noqa: E402
    cluster_scenarios,
    correlated_cluster_scenarios,
    correlated_job_scenarios,
    fat_tree_scenarios,
    job_scenarios,
    pair_scenarios,
    stack_pytrees,
    stack_scenarios,
)
from repro_torch.net.telemetry import (  # noqa: E402
    TelemetrySpec, frame_select, init_frame, record, series,
)
from repro_torch.net.topology import (  # noqa: E402
    fat_tree, init_shared_fabric, leaf_spine, link_telemetry, null_schedule,
)
from repro_torch.net.transport import (  # noqa: E402
    TransportConfig,
    simulate_flows,
    simulate_message,
)
from repro_torch.serve_router import Router  # noqa: E402

GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
GOLDEN_FIELDS = ("cct", "sent_total", "dropped_total", "final_b", "received")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core rate

# The golden case table of tests/golden/gen_golden_transport.py, copied so
# the script runs where the JAX package cannot be imported.  A CPU test
# holds the two tables equal.
GOLDEN_FABRIC = dict(capacity=4.0, latency=4, queue_limit=16.0, ecn_threshold=6.0,
                     degrade_p=0.02, recover_p=0.1, degrade_factor=0.1,
                     fb_delay=8, ring_len=64)
GOLDEN_TOPOLOGY = dict(n_leaves=4, n_spines=4,
                       pairs=((0, 1), (0, 2), (3, 1), (2, 3)), uplink_capacity=8.0)
_BASELINES = ("ECMP", "RR", "RAND_STATIC", "RAND_ADAPTIVE", "WAM")
_NEW = ("PRIME", "STRACK", "CC_COUPLED")


def _message_cases(file, policies):
    return [dict(file=file, name=f"{p}/{'coded' if coded else 'arq'}", fabric="bundle",
                 n=4, cfg=dict(policy=p, coded=coded, rate=16), n_packets=256,
                 seed=7, horizon=512)
            for p in policies for coded in (True, False)]


GOLDEN_CASES = (
    _message_cases("transport_seed.npz", _BASELINES)
    + [dict(file="transport_seed.npz", name="WAM/default8", fabric="bundle", n=8,
            cfg=dict(policy="WAM"), n_packets=512, seed=0, horizon=1024)]
    + _message_cases("transport_policies.npz", _NEW)
    + [dict(file=f, name=f"FLOWS/{p}", fabric="leaf_spine", n=4,
            cfg=dict(policy=p, rate=16), n_packets=128, seed=3, horizon=512)
       for f, p in [("transport_seed.npz", "WAM")]
       + [("transport_policies.npz", p) for p in _NEW]]
)

# the full-width cell
WIDE_LEAVES, WIDE_SPINES, WIDE_FLOWS = 64, 16, 4096
WIDE_RATE, WIDE_PACKETS, WIDE_HORIZON = 32, 256, 2048
# the fat-tree family: bench_scaleout.py's full pass (:79-91), unsharded
# Cut: horizon 1,024 in place of the bench's 2,048.  Every flow finishes by
# tick 288, so the cct and its digest are unchanged; only the two ECMP runs
# that never settle early (incast, oversubscription) run fewer ticks.
FAT_FLOWS, FAT_PACKETS, FAT_HORIZON, FAT_RATE = 4096, 4, 1024, 32
FAT_GRID = dict(n_pods=8, leaves_per_pod=4, spines_per_pod=2, cores_per_spine=2)
FAT_CAPACITY, FAT_HOST_RATE = 32.0, 64.0
FAT_TELEMETRY = dict(stride=16, window=128)
FAT_POLICIES = ("ECMP", "WAM")
# the card-against-CPU sweeps: the CPU tests' families
SMALL_POLICIES, SMALL_HORIZON, SMALL_PACKETS = ("ECMP", "WAM", "CC_COUPLED"), 256, 32
SMALL_TELEMETRY = dict(stride=4, window=64)
# the job cell: benchmarks/bench_job_ettr.py's full pass (:58-98) for one
# model, ECMP and WAM, one draw
JOB_ARCH, JOB_WORKERS, JOB_TP, JOB_ITERATIONS = "qwen3-8b", 4, 8, 2
JOB_RATE, JOB_MAX_SHARD, JOB_HORIZON, JOB_EXIT_CHUNK = 32, 512, 2048, 16
JOB_POLICIES = ("ECMP", "WAM")
# the cluster cell: benchmarks/bench_cluster.py's full pass (:71-100), one
# of its scenarios (cut: flap_during_overlap, to keep the script within
# eight minutes), ECMP and WAM, one draw
CLUSTER_ARCHS, CLUSTER_MAX_SHARD, CLUSTER_HORIZON = ("xlstm-350m", "qwen3-8b"), 256, 1024
CLUSTER_SCENARIOS = ("rings_overlapped",)
# The JAX package's cct digests at these settings (`_digest` of cct[6, 2,
# 1, 1, 18] of the job cell and of the cluster scenarios' raw cct stacked,
# [1, 2, 1, 3, 18, 8]), computed on the CPU with jax 0.9.0:
#
#   PYTHONPATH=src JAX_PLATFORMS=cpu python - <<'EOF'
#   import hashlib, jax, numpy as np
#   from repro.net import cluster as CL, jobs as J, scenarios as S, sender as SD
#   from repro.net.transport import Policy
#   d = lambda c: hashlib.sha256(np.asarray(c, np.float32).tobytes()).hexdigest()[:16]
#   with jax.threefry_partitionable(False):
#       spec = SD.SenderSpec(rate_cap=32, early_exit=True, exit_chunk=16)
#       sp = SD.policy_sweep_params((Policy.ECMP, Policy.WAM), rate=32)
#       keys = jax.random.split(jax.random.PRNGKey(0), 2)[:1]
#       job = J.compile_job("qwen3-8b", workers=4, tp=8, iterations=2, rate=32,
#                           max_shard=512)
#       sc = S.job_scenarios(workers=4, horizon=2048)
#       ins = [J.job_step_inputs([job], s, 2048) for _, s in sc.values()]
#       print(d(J.sweep_job_steps_scenarios(
#           S.stack_pytrees([t for t, _ in sc.values()]),
#           S.stack_pytrees([s for s, _ in ins]), spec, sp, ins[0][1], keys, 2048)[0]))
#       js = [J.compile_job(a, workers=4, tp=8, iterations=2, rate=32, max_shard=256)
#             for a in ("xlstm-350m", "qwen3-8b")]
#       cs = S.cluster_scenarios(js, horizon=2048)
#       raw = []
#       for n in ("rings_overlapped",):
#           c, t, s = cs[n]
#           scheds, sizes = CL.cluster_inputs(c, s, 1024)
#           raw.append(CL.sweep_cluster_rounds(t, scheds, spec, sp, sizes, keys,
#                                              1024)["cct"])
#       print(d(np.stack(raw)))
#   EOF
#
# `tests/test_torch_smoke_pins.py` recomputes both on the CPU.
JOB_DIGEST, CLUSTER_DIGEST = "96419a91aea6b0c4", "cc1ada697e2a514d"
# the card-against-CPU job and cluster runs: the CPU tests' sizes
SMALL_JOB_POLICIES, SMALL_JOB_HORIZON = ("ECMP", "WAM", "RAND_ADAPTIVE", "CC_COUPLED"), 384
SMALL_JOB_TELEMETRY = dict(stride=4, window=32)
# phase `shard`: the fat-tree family's cct digest (the JAX package's, as
# benchmarks/bench_scaleout.py prints it), and the CPU tests' sizes of
# tests/test_torch_shard_flows.py and test_torch_shard_jobs.py
FAT_DIGEST = "a60b023667ba5fa2"
SHARD_RATE, SHARD_HORIZON = 16, 512
SHARD_PAIRS, SHARD_SIZES = ((0, 2), (1, 3), (2, 1), (0, 3), (3, 0)), (48, 0, 24, 64, 16)
SHARD_POLICIES = ("ECMP", "WAM")
# a dependent float32 add waits this many cycles of the SM clock on Hopper's
# CUDA cores (the latency of FADD; the card's clock is read with nvidia-smi)
FADD_CYCLES = 4
# the coded message: K source symbols of P uint32 words (4 KiB, an MTU's
# payload) make 32 MiB, about one DDP gradient bucket (bucket_cap_mb = 25)
CODED_K, CODED_P, CODED_DMAX = 8192, 1024, 32
CODED_R = int(CODED_K * 1.6) + 32
# the router run
ROUTER_REPLICAS, ROUTER_WINDOWS, ROUTER_BATCH, ROUTER_SLOW = 64, 200, 4096, 7
# dense serving: qwen3-8b at full width, 4 prompts of 2,048 tokens, 64 tokens
DENSE_ARCH, DENSE_BATCH, DENSE_PROMPT, DENSE_GEN = "qwen3-8b", 4, 2048, 64
# the smoke-size runs: tests/test_torch_zoo.py's shapes and tolerance
SMOKE_BATCH, SMOKE_PROMPT, SMOKE_STEPS, SMOKE_FRAMES, MODEL_TOL = 2, 48, 8, 40, 5e-2
# the zoo: the eight archs beyond the dense pair, at their smoke configs
ZOO_ARCHS = ("qwen1.5-4b", "starcoder2-3b", "dbrx-132b", "arctic-480b", "jamba-v0.1-52b",
             "xlstm-350m", "whisper-large-v3", "llava-next-mistral-7b")
# jamba-v0.1-52b at its published widths, cut to one period of 8 of its 32
# layers (7 mamba, 1 attention, 4 MoE, 4 MLP: ~27 GB of bf16 weights; all
# 32 layers hold ~104 GB); the dense cell's prompts and generation
JAMBA_LAYERS, JAMBA_BATCH, JAMBA_PROMPT, JAMBA_GEN = 8, 4, 2048, 64
# whisper-large-v3 whole (32 encoder + 32 decoder layers): its 30-second
# window of 1,500 frames after the conv stem, 4 prompts of 384 tokens and
# 64 generated (448, its decoder's context)
WHISPER_BATCH, WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_GEN = 4, 1500, 384, 64
# Full width, kernels against plain versions.  Through 36 bf16 layers a
# rounding difference in an attention output is amplified: on an H100 the
# plain prefill attention in f32 and in float64 give logits (std 1.0) that
# differ by rms 0.035 and at most 0.20 (scripts/dense_noise_floor.py).
# The kernels are held to that scale: rms of the difference at most 0.1
# of the logits' rms, no logit off by more than 0.5, and greedy tokens
# equal wherever the top-1 / top-2 margin exceeds twice the largest
# difference.
FULL_RMS_TOL, FULL_MAX_TOL = 0.1, 0.5
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py's
# flash_attention's backward against its plain version on the same inputs
# (tests/test_torch_cuda.py's): both take every product and sum in f32, so
# f32 results differ by the order of the sums, bf16 ones by a rounding step
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# training at smoke size, card against CPU: the CPU tests' runs and
# tolerances (tests/test_torch_train.py, test_torch_train_zoo.py): 3 steps
# of 4 x 64 tokens; losses within 2e-3, step-1 gradients within 5e-2
# relative L2 per leaf (jamba's within 0.1)
TRAIN_SMOKE_STEPS, TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ = 3, 4, 64
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 2e-3, {"jamba-v0.1-52b": 0.1}
# the full-width training cell: qwen3-8b at its published widths, cut to 4
# of its 36 layers (f32 params, grads and AdamW's m and v of all 36 layers
# would need ~164 GB; 4 layers hold every leaf kind of the dense model),
# SyntheticLM batches of 4 x 2,048 tokens, AdamW at the trainer CLI's
# defaults (lr 3e-3, cosine schedule), 4 steps
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "qwen3-8b", 4, 4, 2048, 4
# The kernels' run against the plain run, each held to the noise floor:
# the plain run against the same run with its attention in float64.  Any
# perturbation of a bf16 rounding spreads through the layers' later bf16
# roundings until the runs differ at bf16's own noise level: on an H100
# the floor is a relative L2 of ~0.013 in every leaf of the step-1
# gradient and up to 1.3e-4 in the losses (measured on one H100), and the
# kernels' run stood 1.2 (losses) and 1.55 (gradients) times the floor
# from the plain run.  As the serving cell holds its kernels at about 3
# times its floor (FULL_RMS_TOL against rms 0.035), every step's loss and
# every leaf of the step-1 gradient must stay within 4 times the floor.
TRAIN_FLOOR_RATIO = 4.0
# the smoke configs whose scans run more than one 64-step chunk: also trained
# at 256 tokens, card against CPU
TRAIN_SMOKE_LONG_ARCHS, TRAIN_SMOKE_LONG_SEQ = ("xlstm-350m", "jamba-v0.1-52b"), 128
# their step-1 gradients within 0.15 relative L2 per leaf there (losses
# 2e-3 as at 64): bf16 roundings run through twice the recurrent steps and
# compound through the layers.  On an H100 the card has stood 0.0789-0.1006
# (xlstm) and 0.0408-0.0441 (jamba) from the CPU at 4 x 128 tokens; on the
# CPU the port stands 0.082 (xlstm, 2.0x its float64-recurrence floor) and
# 0.18 (jamba, whose forward departs) from the JAX reference
# (tests/test_torch_tie_gradients.py)
TRAIN_LONG_GRAD_TOL = 0.15
# the recurrent training cell: xlstm-350m whole at its published widths (24
# layers, d 1,024, 4 heads, vocab 50,304; arXiv:2405.04517), f32 weights,
# AdamW at the CLI's defaults, SyntheticLM batches of 8 x 2,048 tokens
# (the CLI's --global-batch 8).  Its step is host-bound (every recurrent
# step a few dozen small device operations): minutes on an H100's host,
# more than this script's time allows, so `scripts/profile_cells.py --cell
# train_xlstm` runs it; here one step at 8 x 256 tokens (4 chunks) with
# both scan forms, chunked and unchunked (whose backward holds 16 GiB of
# states a mLSTM sublayer there, 128 GiB at 2,048)
XLSTM_ARCH, XLSTM_BATCH, XLSTM_SEQ = "xlstm-350m", 8, 2048
XLSTM_CMP_SEQ, XLSTM_CMP_STEPS = 256, 1
# the hybrid training cell: jamba-v0.1-52b at its published widths cut to
# the serving cell's period (8 of 32 layers: 7 mamba, 1 attention, 4 MoE,
# 4 MLP; ~27 GB of bf16 weights), bf16 weights and Adafactor (the
# config's), batches of 2 x 2,048 tokens, 2 steps (four runs of it, with
# 27 GB of gradients through the host for each, take ~100 s), step 2 timed
JAMBA_TRAIN_BATCH, JAMBA_TRAIN_SEQ, JAMBA_TRAIN_STEPS = 2, 2048, 2
# the examples (phase `examples`): every examples/torch_*.py at the sizes its
# CPU tests run (the module's SMOKE, cut so that the phase takes well under a
# minute: the ticks are host-bound), on the card and then on the CPU; the
# network examples' returned numbers equal, serving and training within the
# CPU tests' tolerances (MODEL_TOL on the logits, TRAIN_LOSS_TOL on the
# losses)
EXAMPLES_NET = ("quickstart", "telemetry_quickstart", "topology_scenarios_demo",
                "collective_cct_demo", "job_ettr_quickstart", "cluster_contention_demo")


def golden_fabric(n: int, device) -> FabricParams:
    g = GOLDEN_FABRIC

    def full(v, dtype=torch.float32):
        return torch.full((n,), v, dtype=dtype, device=device)

    return FabricParams(
        capacity=full(g["capacity"]), latency=full(g["latency"], torch.int32),
        queue_limit=full(g["queue_limit"]), ecn_threshold=full(g["ecn_threshold"]),
        degrade_p=full(g["degrade_p"]), recover_p=full(g["recover_p"]),
        degrade_factor=full(g["degrade_factor"]), fb_delay=g["fb_delay"],
        ring_len=g["ring_len"])


def golden_config(cfg: dict) -> TransportConfig:
    kw = dict(cfg)
    return TransportConfig(policy=Policy[kw.pop("policy")], **kw)


def wide_pairs():
    L = WIDE_LEAVES
    return [(f % L, (f % L + 1 + (f // L) % (L - 1)) % L) for f in range(WIDE_FLOWS)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of each
    entry function in an ``nvcc -Xptxas -v`` log."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name, spill = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name is not None:
            rows.append((name, int(m.group(1)), *spill))
            name = None
    return rows


def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean time per call on the card's clock (CUDA events around eager
    calls: includes the host's launch overhead when it is the longer)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 100, stream=None) -> float:
    """Mean device time per call: `iters` calls captured in one CUDA graph
    (on ``stream``, default a stream of the graph's own) and replayed, so
    the host's launch overhead drops out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def spray_inputs(rng, rows: int, B: int, n: int, ell: int, dev):
    m = 1 << ell
    counters = torch.as_tensor(rng.integers(0, 2 ** 32, (rows, B), dtype=np.int64), device=dev)
    b = np.stack([np.bincount(rng.integers(0, n, m), minlength=n) for _ in range(rows)])
    c = torch.as_tensor(np.cumsum(b, axis=1).astype(np.int32), device=dev)
    seeds = torch.as_tensor(np.stack([rng.integers(0, m, rows),
                                      rng.integers(0, m // 2, rows) * 2 + 1], axis=1),
                            device=dev)
    return counters, c, seeds


def _rows_inputs(rng, rows: int, n: int, ell: int, variant: int, dev):
    """Row bases within 64 of 2**32 (their lanes wrap) and seeds for the
    row-base form; ``variant`` 0: int64 [R] seeds, 1: int32 bases and
    seeds, 2: int64 bases and 0-d int32 seeds (read with a stride of 0)."""
    _, c, seeds = spray_inputs(rng, rows, 1, n, ell, dev)
    j = torch.as_tensor(rng.integers(2**32 - 64, 2**32, rows), device=dev)
    sa, sb = seeds[:, 0], seeds[:, 1]
    if variant == 1:
        j = torch.where(j >= 2**31, j - 2**32, j).to(torch.int32)
        sa, sb = sa.to(torch.int32), sb.to(torch.int32)
    elif variant == 2:
        sa, sb = sa[0].to(torch.int32), sb[0].to(torch.int32)
    return j, c, sa, sb


def device_op_names(fn, calls: int = 3) -> list:
    """The names of the device operations that ``calls`` calls of ``fn``
    run, from `torch.profiler`; fails when it records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
    if not names:
        raise AssertionError("torch.profiler recorded no device activity")
    return names


def graph_replays_equal(fn, what: str, replays: int = 3):
    """``replays`` replays of one captured call give the eager call's bits."""
    eager = fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(replays):
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, eager):
            raise AssertionError(f"{what}: a graph replay differs from the eager call")
    print(f"[kernels] {what}: {replays} graph replays equal the eager call bit for bit")


def wam_branch_call(rng, dev):
    """The wide tick's WAM branch: 4,096 flows' int64 spray state, profiles
    of 16 paths, 32 lanes."""
    F, n, ell = WIDE_FLOWS, WIDE_SPINES, 10
    b = torch.as_tensor(np.stack([np.bincount(rng.integers(0, n, 1 << ell), minlength=n)
                                  for _ in range(F)]), device=dev)
    spray = SprayState(j=torch.as_tensor(rng.integers(0, 2**32, F), device=dev),
                       sa=torch.as_tensor(rng.integers(0, 1 << ell, F), device=dev),
                       sb=torch.as_tensor(rng.integers(0, 512, F) * 2 + 1, device=dev),
                       ell=ell, method=int(SprayMethod.SHUFFLE_1))
    none = torch.zeros((F, 0), device=dev)
    ps = PolicyState(rtt=none, penalty=none,
                     entropy=torch.zeros((F, 0), dtype=torch.int64, device=dev), ccw=none)
    ecmp = torch.zeros(F, dtype=torch.int64, device=dev)
    prof = make_profile(b, ell)
    return lambda: assign_lanes(Policy.WAM, WIDE_RATE, n, spray, prof, ecmp, ps, None)


def phase_kernels(dev):
    """spray_select against its plain version; returns the kernel's row."""
    rng = np.random.default_rng(0)
    checked = 0
    shapes = [(1, 131072)]
    for method in SprayMethod:
        for ell in (8, 10, 16):
            for n in (1, 4, 16, 128):
                for rows, B in shapes:
                    cnt, c, seeds = spray_inputs(rng, rows, B, n, ell, dev)
                    got = spray_select(cnt, c, seeds, ell=ell, method=int(method))
                    want = spray_select_plain(cnt, c, seeds, ell=ell, method=int(method))
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"spray_select differs: {method.name} ell={ell} n={n}")
                    checked += 1
    for rows, B, n in ((1, 131071, 16), (3, 1000, 7), (WIDE_FLOWS, WIDE_RATE, WIDE_SPINES),
                       (4, 3000, 129), (4, 3000, 256), (4, 3000, 1000), (2, 700, 20000)):
        for method in SprayMethod:
            cnt, c, seeds = spray_inputs(rng, rows, B, n, 10, dev)
            got = spray_select(cnt, c, seeds, ell=10, method=int(method))
            want = spray_select_plain(cnt, c, seeds, ell=10, method=int(method))
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"spray_select differs at [{rows}, {B}] n={n} {method.name}")
            checked += 1
    print(f"[kernels] spray_select equals its plain version in {checked} cases")

    # the row-base form: every method, ell, path count and input variant
    checked = 0
    row_shapes = {1: (WIDE_FLOWS, WIDE_RATE), 16: (WIDE_FLOWS, WIDE_RATE), 128: (64, 1000),
                  20000: (2, 700)}
    for method in SprayMethod:
        for ell in (8, 10, 16):
            for n, (rows, B) in row_shapes.items():
                for variant in range(3):
                    j, c, sa, sb = _rows_inputs(rng, rows, n, ell, variant, dev)
                    before = spray_select.launches
                    got = spray_select_rows(j, c, sa, sb, B, ell=ell, method=int(method))
                    want = spray_select_rows_plain(j, c, sa, sb, B, ell=ell, method=int(method))
                    torch.cuda.synchronize()
                    if not torch.equal(got, want) or spray_select.launches != before + 1:
                        raise AssertionError(f"spray_select_rows differs: {method.name} ell={ell} "
                                             f"n={n} variant {variant}")
                    checked += 1
    print(f"[kernels] spray_select_rows (row bases wrapping past 2**32; int64, int32, stride-0 "
          f"seeds) equals its plain version in {checked} cases")

    # one device operation a call on the main path
    wam = wam_branch_call(rng, dev)
    router_profile = quantize_profile(0.5 + rng.random(64), 10, device=dev)
    state = make_spray_state(router_profile, sa=333, sb=735, j0=2**32 - 100)
    for what, fn in (("the WAM branch [4096 x 32], 16 paths", wam),
                     ("spray_paths [1 x 4096], 64 paths",
                      lambda: spray_paths(state, router_profile, ROUTER_BATCH))):
        names = device_op_names(fn)
        if len(names) != 3 or not all("spray_select" in x for x in names):
            raise AssertionError(f"{what}: 3 calls ran {names}")
        print(f"[kernels] {what}: one device operation a call ({names[0]})")

    # the main path's shape: one row per flow, rate_cap lanes, n = 16
    rows, B, n, ell = WIDE_FLOWS, WIDE_RATE, WIDE_SPINES, 10
    cnt, c, seeds = spray_inputs(rng, rows, B, n, ell, dev)
    cnt32 = torch.where(cnt >= 2 ** 31, cnt - 2 ** 32, cnt).to(torch.int32)
    seeds32 = seeds.to(torch.int32)
    method = int(SprayMethod.SHUFFLE_1)
    j, sa, sb = cnt[:, 0].contiguous(), seeds[:, 0].contiguous(), seeds[:, 1].contiguous()
    out = spray_select(cnt32, c, seeds32, ell=ell, method=method)
    graph_replays_equal(lambda: spray_select_rows(j, c, sa, sb, B, ell=ell, method=method),
                        "spray_select_rows at the wide tick's shape")
    keys = spray_key(cnt, seeds[:, :1], seeds[:, 1:], ell, method).to(torch.int32)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    calls = {
        "kernel": lambda: spray_select(cnt32, c, seeds32, ell=ell, method=method),
        "main_path": lambda: spray_select_rows(j, c, sa, sb, B, ell=ell, method=method),
        "wam_branch": wam,
        "plain": lambda: spray_select_plain(cnt, c, seeds, ell=ell, method=method),
        "searchsorted": lambda: torch.searchsorted(c, keys, right=True),
        "launch_floor": lambda: one.add_(1),
    }
    eager = {k: time_ms(f) for k, f in calls.items()}
    graphed = {k: device_ms(f) for k, f in calls.items()}
    print("[kernels] eager ms per call: " + ", ".join(f"{k} {v:.6f}" for k, v in eager.items()))
    print("[kernels] graph-replayed ms per call: "
          + ", ".join(f"{k} {v:.6f}" for k, v in graphed.items()))
    ms, plain_ms, library_ms = graphed["kernel"], graphed["plain"], graphed["searchsorted"]
    err = (out.to(torch.int64) - spray_select_plain(cnt, c, seeds, ell=ell, method=method)).abs().max()
    # the bound counts the TPU kernel's function (explicit counters), as it always has
    nbytes = 4 * (cnt32.numel() + c.numel() + seeds32.numel() + out.numel())
    ops = rows * B * (5 + 2 * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / CUDA_CORE_OPS_PER_S * 1e3
    print(f"[kernels] spray_select [{rows}x{B}] n={n}: kernel {ms:.6f} ms, main-path form (int64 "
          f"row bases and seeds) {graphed['main_path']:.6f} ms, WAM branch "
          f"{graphed['wam_branch']:.6f} ms, plain {plain_ms:.6f} ms, searchsorted "
          f"{library_ms:.6f} ms, launch floor (1-element add_) {graphed['launch_floor']:.6f} ms, "
          f"bound {max(t_bytes, t_ops):.6f} ms")
    return dict(name="spray_select", route="cuda",
                source="src/repro_torch/kernels/csrc/spray_select.cu",
                replaces="src/repro/kernels/spray_select.py:79", launches=0,
                max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms)


def coded_message():
    """The full-width message: payload and encoding drawn from seed 0."""
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 2**32, (CODED_K, CODED_P), dtype=np.uint32)
    neigh, valid = fountain.sample_encoding(CODED_K, CODED_R, rng, dmax=CODED_DMAX)
    return payload, neigh, valid


def lt_inputs(rng, K, P, R, dmax, lo, hi, dev):
    payload = torch.as_tensor(rng.integers(-2**31, 2**31, (K, P)).astype(np.int32), device=dev)
    neigh = torch.as_tensor(rng.integers(lo, hi, (R, dmax)).astype(np.int32), device=dev)
    valid = torch.as_tensor(rng.random((R, dmax)) < 0.7, device=dev)
    return payload, neigh, valid


def phase_lt_encode(dev, message):
    """lt_encode against its plain version; returns the kernel's row."""
    rng = np.random.default_rng(1)
    cases = []
    for K, P, R, dmax in ((64, 512, 16, 8), (128, 1024, 32, 16), (16, 512, 8, 4)):
        cases.append((f"{K}x{P}->{R} dmax {dmax}", lt_inputs(rng, K, P, R, dmax, 0, K, dev)))
    copy = torch.as_tensor(rng.integers(-2**31, 2**31, (8, 512)).astype(np.int32), device=dev)
    cases.append(("degree-one copy", (copy, torch.arange(8, device=dev).reshape(8, 1),
                                      torch.ones((8, 1), dtype=torch.bool, device=dev))))
    for K, P, R, dmax in ((37, 1001, 13, 5), (5, 3, 7, 40), (1, 1, 1, 1), (300, 6, 11, 300),
                          (1000, 1023, 257, 33), (2048, 1024, 3001, 32)):
        inputs = lt_inputs(rng, K, P, R, dmax, -2 * K - 3, 2 * K + 3, dev)
        cases.append((f"ragged {K}x{P}->{R} dmax {dmax}", inputs))
        cases.append((f"ragged {K}x{P}->{R} dmax {dmax}, int64 idx",
                      (inputs[0], inputs[1].to(torch.int64) * (2**33 + 1), inputs[2])))
    flat = torch.as_tensor(rng.integers(-2**31, 2**31, 33 * 512 + 1).astype(np.int32), device=dev)
    _, nb, ok = lt_inputs(rng, 33, 512, 19, 6, 0, 33, dev)
    cases.append(("unaligned payload", (flat[1:].view(33, 512), nb, ok)))
    # the vector route's edges: degree 200 (50 rounds of 4 gathers), rows
    # of 3 tiles of 256 vectors with a ragged last, a one-row payload
    deep = lt_inputs(rng, 64, 1024, 40, 200, -131, 131, dev)
    deep[2].fill_(True)
    deep[2][0] = False  # and a row with no valid slot
    cases.append(("degree 200", deep))
    cases.append(("P = 3000 (tiles of 256, 256, 238 vectors)",
                  lt_inputs(rng, 300, 3000, 50, 60, -603, 603, dev)))
    cases.append(("K = 1", lt_inputs(rng, 1, 1024, 9, 3, -5, 5, dev)))
    payload_np, neigh_np, valid_np = message
    payload = as_int32_bits(payload_np).to(dev)
    neigh = torch.as_tensor(neigh_np, device=dev)
    valid = torch.as_tensor(valid_np, device=dev)
    cases.append((f"full width {CODED_K}x{CODED_P}->{CODED_R}", (payload, neigh, valid)))
    routes = {"vector": 0, "word": 0}
    for name, args in cases:
        got = lt_encode(*args)
        want = lt_encode_plain(*args)
        torch.cuda.synchronize()
        route = lt_plan(args[0].contiguous())
        routes[route] += 1
        if not torch.equal(got, want):
            raise AssertionError(f"lt_encode differs from its plain version: {name} ({route})")
        if name == "degree-one copy" and not torch.equal(got, copy):
            raise AssertionError("lt_encode: a degree-one encoding is not a copy")
        if name == "degree 200" and got[0].any():
            raise AssertionError("lt_encode: a row with no valid slot is not zero")
        if name == "unaligned payload" and route != "word":
            raise AssertionError("lt_encode: an unaligned payload did not take the word route")
    if lt_plan(payload) != "vector":
        raise AssertionError("lt_encode: the coded cell does not take the vector route")
    print(f"[kernels] lt_encode equals its plain version in {len(cases)} cases "
          f"({routes['vector']} on the vector route, {routes['word']} on the word route)")
    graph_replays_equal(lambda: lt_encode(payload, neigh, valid),
                        "lt_encode at the coded shape (vector route)")

    err = (got.to(torch.int64) - want.to(torch.int64)).abs().max()
    eager = {"kernel": time_ms(lambda: lt_encode(payload, neigh, valid)),
             "plain": time_ms(lambda: lt_encode_plain(payload, neigh, valid), iters=10,
                              warmup=2)}
    graphed = {"kernel": device_ms(lambda: lt_encode(payload, neigh, valid)),
               "plain": device_ms(lambda: lt_encode_plain(payload, neigh, valid), iters=10)}
    print("[kernels] lt_encode eager ms per call: "
          + ", ".join(f"{k} {v:.6f}" for k, v in eager.items()))
    print("[kernels] lt_encode graph-replayed ms per call: "
          + ", ".join(f"{k} {v:.6f}" for k, v in graphed.items()))
    # the bound: each referenced payload row, the index and mask arrays read
    # once, the output written once; one XOR per gathered word
    degree_sum = int(valid_np.sum())
    rows_used = int(np.unique(neigh_np[valid_np]).size)
    nbytes = 4 * rows_used * CODED_P + 4 * CODED_R * CODED_P + 5 * neigh_np.size
    ops = degree_sum * CODED_P
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / CUDA_CORE_OPS_PER_S * 1e3
    print(f"[kernels] lt_encode [{CODED_K}x{CODED_P} -> {CODED_R}, dmax {CODED_DMAX}]: degree sum "
          f"{degree_sum} (mean {degree_sum / CODED_R:.4f}), {rows_used} payload rows used; "
          f"{nbytes} B -> {t_bytes:.6f} ms, {ops} XORs -> {t_ops:.6f} ms; "
          f"gathered rows {4 * degree_sum * CODED_P} B")
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    ms = graphed["kernel"]
    print(f"[kernels] lt_encode: kernel {ms:.6f} ms ({100 * max(t_bytes, t_ops) / ms:.1f}% of the "
          f"bound; {nbytes / ms / 1e6:.1f} GB/s of the bound's bytes, "
          f"{4 * degree_sum * CODED_P / ms / 1e6:.1f} GB/s gathered), plain "
          f"{graphed['plain']:.6f} ms, bound {max(t_bytes, t_ops):.6f} ms ({bound_by}); library: "
          f"none (no single PyTorch call computes a gather-XOR reduction)")
    return dict(name="lt_encode", route="cuda",
                source="src/repro_torch/kernels/csrc/lt_encode.cu",
                replaces="src/repro/kernels/lt_encode.py:52", launches=0,
                max_abs_err=float(err), ms=graphed["kernel"], plain_ms=graphed["plain"],
                bound_ms=max(t_bytes, t_ops), bound_by=bound_by, library_ms=None)


def sm_clock_hz() -> float:
    """The card's largest SM clock, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def fold_values(rng, n: int, dev) -> torch.Tensor:
    """float32 values of both signs from 2**-30 to 2**20, about 5% zeros of
    either sign: a change in the order of additions changes their sums."""
    mag = np.exp2(rng.uniform(-30, 20, n))
    vals = np.where(rng.random(n) < 0.5, -mag, mag) * (rng.random(n) > 0.05)
    vals = vals.astype(np.float32)
    vals[rng.random(n) < 0.02] = -0.0
    return torch.as_tensor(vals, device=dev)


def intra_pod_pairs(flows: int):
    """Flow f from leaf f mod 32 to the next leaf of its pod: all traffic
    turns at the spines, so hops 1 and 2 of every path ride the bypass."""
    lp = FAT_GRID["leaves_per_pod"]
    n_leaves = FAT_GRID["n_pods"] * lp
    return [(f % n_leaves, (f % n_leaves) // lp * lp + (f % n_leaves % lp + 1) % lp)
            for f in range(flows)]


def fat_family(flows=None, horizon=None, grid=None, capacity=None, host_rate=None):
    """The fat-tree family, by default at full width."""
    return fat_tree_scenarios(flows=flows or FAT_FLOWS, horizon=horizon or FAT_HORIZON,
                              link_capacity=capacity or FAT_CAPACITY,
                              host_rate=host_rate or FAT_HOST_RATE, **(grid or FAT_GRID))


def phase_link_fold(dev):
    """link_fold against its plain version; returns the kernel's row."""
    rng = np.random.default_rng(2)
    family = fat_family()
    routes = [("depth 1", torch.randperm(4096, generator=torch.Generator().manual_seed(0))
               .to(torch.int32).reshape(1, 4096, 1), 4096),
              ("wide cell", leaf_spine(WIDE_LEAVES, WIDE_SPINES, wide_pairs()).route,
               2 * WIDE_LEAVES * WIDE_SPINES)]
    routes += [(name, topo.route, topo.links) for name, (topo, _) in family.items()
               if name in ("inter_pod_uniform", "inter_pod_incast")]
    bypass = fat_tree(**FAT_GRID, flow_pairs=intra_pod_pairs(FAT_FLOWS))
    routes.append(("intra-pod on the bypass", bypass.route, bypass.links))
    ragged = torch.as_tensor(rng.integers(0, 300, (3, 500, 4)).astype(np.int32) * 3)
    routes.append(("ragged, 2/3 of the links empty", ragged, 1000))
    clock = sm_clock_hz()
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    floor = device_ms(lambda: one.add_(1))
    row = None
    for name, route, links in routes:
        seg = link_segments(route.to(dev), links)
        vals = fold_values(rng, seg.entries, dev).reshape(route.shape)
        base = fold_values(rng, links, dev)
        base[: links // 7] = -0.0
        before = link_fold.launches
        got = link_fold(vals, seg, base)
        want = link_fold_plain(vals, seg, base)
        torch.cuda.synchronize()
        if link_fold.launches != before + 1:
            raise AssertionError(f"link_fold, {name}: not one launch a call")
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            raise AssertionError(f"link_fold differs from its plain version: {name} "
                                 f"({bad} of {links} links)")
        ms = device_ms(lambda: link_fold(vals, seg, base))
        nbytes = 4 * (2 * seg.entries + 3 * links + 1)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_chain = seg.depth * FADD_CYCLES / clock * 1e3
        print(f"[kernels] link_fold, {name}: {links} links, {seg.entries} entries, deepest "
              f"{seg.depth}: bit-equal to the plain version; {ms:.6f} ms (launch floor "
              f"{floor:.6f}), bound {max(t_bytes, t_chain):.6f} ms (chain of {seg.depth} adds "
              f"x {FADD_CYCLES} cycles at {clock / 1e6:.0f} MHz {t_chain:.6f}, {nbytes} B "
              f"{t_bytes:.6f})")
        if name == "inter_pod_incast":  # the main path's deepest fold
            flat_links = route.reshape(-1).to(dev, torch.int64)
            graph_replays_equal(lambda: link_fold(vals, seg, base),
                                "link_fold at inter_pod_incast's shape")
            plain_ms = device_ms(lambda: link_fold_plain(vals, seg, base), iters=1)
            plain_eager = time_ms(lambda: link_fold_plain(vals, seg, base), iters=1, warmup=1)
            library_ms = device_ms(lambda: base.index_add(0, flat_links, vals.reshape(-1)))
            print(f"[kernels] link_fold at inter_pod_incast's shape: kernel {ms:.6f} ms, plain "
                  f"{plain_ms:.6f} ms graph / {plain_eager:.6f} eager ({2 * seg.depth} "
                  f"launches), index_add {library_ms:.6f} ms (not in this order)")
            row = dict(name="link_fold", route="cuda",
                       source="src/repro_torch/kernels/csrc/link_fold.cu",
                       replaces="src/repro/net/topology.py:447", launches=0,
                       max_abs_err=float((got - want).abs().max()), ms=ms,
                       plain_ms=plain_ms, bound_ms=max(t_bytes, t_chain),
                       bound_by="bytes" if t_bytes >= t_chain else "operations",
                       library_ms=library_ms)
    print(f"[kernels] link_fold equals its plain version bit for bit in {len(routes)} cases")
    return row


def phase_goldens(dev):
    files = {f: np.load(os.path.join(GOLDEN_DIR, f)) for f in
             ("transport_seed.npz", "transport_policies.npz")}
    g = GOLDEN_TOPOLOGY
    topo = leaf_spine(g["n_leaves"], g["n_spines"], g["pairs"],
                      uplink_capacity=g["uplink_capacity"], device=dev)
    sched = null_schedule(topo.links, device=dev)
    t0 = time.time()
    for case in GOLDEN_CASES:
        cfg = golden_config(case["cfg"])
        key = prng.PRNGKey(case["seed"])
        if case["fabric"] == "bundle":
            r = simulate_message(golden_fabric(case["n"], dev), cfg, case["n_packets"],
                                 key, case["horizon"], device=dev)
        else:
            r = simulate_flows(topo, sched, cfg, case["n_packets"], key,
                               case["horizon"], device=dev)
        for field in GOLDEN_FIELDS:
            got = getattr(r, field).cpu().numpy()
            want = files[case["file"]][f"{case['name']}/{field}"]
            if got.dtype != want.dtype or not np.array_equal(got, want):
                raise AssertionError(f"golden {case['name']}/{field}: {got} != {want}")
    print(f"[goldens] {len(GOLDEN_CASES)} cases bit-identical on "
          f"{', '.join(GOLDEN_FIELDS)} ({time.time() - t0:.3f} s)")


def run_wide(policy: str, dev, *, plain_spray: bool = False):
    topo = leaf_spine(WIDE_LEAVES, WIDE_SPINES, wide_pairs(), uplink_capacity=8.0,
                      degrade_p=0.002, device=dev)
    sched = null_schedule(topo.links, device=dev)
    cfg = TransportConfig(policy=Policy[policy], rate=WIDE_RATE, early_exit=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = simulate_flows(topo, sched, cfg, WIDE_PACKETS, prng.PRNGKey(0), WIDE_HORIZON,
                       device=dev, plain_spray=plain_spray)
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def phase_wide(dev, kernel_rows):
    results = {}
    for policy in ("WAM", "ECMP"):
        spray_select.launches = link_fold.launches = 0
        r, secs, peak = run_wide(policy, dev)
        launches, folds = spray_select.launches, link_fold.launches
        if folds <= 0:
            raise AssertionError(f"the wide {policy} run never launched link_fold")
        kernel_rows["link_fold"]["launches"] += folds
        if not bool(r.finished.all()):
            raise AssertionError(f"{policy}: {int((~r.finished).sum())} flows did not finish")
        cct = r.cct.cpu().numpy()
        ticks = int(r.ticks_run)
        decisions = ticks * WIDE_FLOWS * WIDE_RATE
        print(f"[wide] {policy}: ticks {ticks}, {1e3 * secs / ticks:.4f} ms/tick, "
              f"{decisions / secs:.1f} path decisions/s, cct p50 {np.percentile(cct, 50)} "
              f"p99 {np.percentile(cct, 99)}, peak memory {peak} B, "
              f"spray_select launches {launches}, link_fold launches {folds}")
        results[policy] = r
        if policy == "WAM":
            if launches <= 0:
                raise AssertionError("the WAM run never launched spray_select")
            kernel_rows["spray_select"]["launches"] += launches
    plain, _, _ = run_wide("WAM", dev, plain_spray=True)
    for field in ("cct", "sent_total", "dropped_total", "final_b", "received",
                  "finished", "link_served", "link_busy"):
        if not torch.equal(getattr(plain, field), getattr(results["WAM"], field)):
            raise AssertionError(f"WAM with the plain spray differs on {field}")
    print("[wide] WAM with the plain spray on the card: identical outputs")


def _digest(cct: torch.Tensor) -> str:
    """benchmarks/bench_scaleout.py's cct digest."""
    return hashlib.sha256(np.ascontiguousarray(
        cct.cpu().numpy().astype(np.float32)).tobytes()).hexdigest()[:16]


def _equal_runs(a, b, what):
    """Every field of two SimResults, or of two (SimResult, frame) pairs."""
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if u.dtype != v.dtype or u.shape != v.shape or not torch.equal(u.cpu(), v.cpu()):
                raise AssertionError(f"{what}: {f.name} differs")


def stride_tick_telemetry_waits(topo, dev) -> None:
    """A stride tick's telemetry on the card, under torch's sync debug mode
    "error": the link reader (one `link_fold` launch) and `record` at the
    full width raise if they make the host wait for the card.  The CSR the
    link reader folds over is built before, once a run, as in the run."""
    topo = sender.to_device(topo, dev)
    F, n, L = topo.flows, topo.n, topo.links
    spec = TelemetrySpec(**FAT_TELEMETRY)
    frame = init_frame(spec, (F,), n, L, device=dev)
    state = init_shared_fabric(topo)
    z = torch.zeros(F, device=dev)
    fpp = torch.zeros(F, n, device=dev)
    link_telemetry(topo, state)  # builds the cached CSR once, as a run's first tick does
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        capture = (state.queue == 0).all()  # holds: a fresh fabric is empty
        frame = record(spec, frame, capture, tick=FAT_TELEMETRY["stride"], m=1 << 10,
                       alloc=torch.ones(F, n, dtype=torch.int32, device=dev), sent_pp=fpp,
                       dropped_pp=fpp, debt=z, emitted=z, received=z,
                       j=torch.zeros(F, dtype=torch.int64, device=dev),
                       link=link_telemetry(topo, state))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if int(frame.count) != 1 or int(frame.tick[0]) != FAT_TELEMETRY["stride"]:
        raise AssertionError("fat-tree: the stride-tick check did not record its sample")


def _small_families():
    """The CPU tests' families: the pair scenarios of 4 flows, and the
    fat-tree family of 64 flows on 4 pods x 2 x 2 x 2 with one placement
    that mixes intra- and inter-pod flows."""
    grid = dict(n_pods=4, leaves_per_pod=2, spines_per_pod=2, cores_per_spine=2)
    fat = list(fat_family(flows=64, horizon=SMALL_HORIZON, grid=grid, capacity=8.0,
                          host_rate=32.0).values())
    mixed = [(2 * (f % 4), 2 * (f % 4) + 1) if f % 2 else (f % 8, (f + 3) % 8)
             for f in range(64)]
    topo = fat_tree(**grid, flow_pairs=mixed)
    fat.append((topo, null_schedule(topo.links)))
    return {"pair": stack_scenarios(list(pair_scenarios(flows=4, horizon=SMALL_HORIZON)
                                         .values())),
            "fat-tree": stack_scenarios(fat)}


def phase_fat_tree(dev, rows):
    family = fat_family()
    names = list(family)
    topos, scheds = stack_scenarios(list(family.values()))
    spec = sender.SenderSpec(rate_cap=FAT_RATE, early_exit=True,
                             telemetry=TelemetrySpec(**FAT_TELEMETRY))
    sp = sender.policy_sweep_params([Policy[p] for p in FAT_POLICIES], rate=FAT_RATE)
    keys = prng.split(prng.PRNGKey(7), 1)
    runs = {}
    last = [time.perf_counter(), 0, 0]

    def on_run(idx, out):
        torch.cuda.synchronize()
        now = time.perf_counter()
        runs[idx] = (now - last[0], link_fold.launches - last[1],
                     spray_select.launches - last[2], out[0])
        last[:] = [now, link_fold.launches, spray_select.launches]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    link_fold.launches = spray_select.launches = 0
    t0 = last[0] = time.perf_counter()
    result, frame = sender.sweep_flows_scenarios(topos, scheds, spec, sp, FAT_PACKETS, keys,
                                                 FAT_HORIZON, device=dev, on_run=on_run)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    folds, sprays = link_fold.launches, spray_select.launches
    peak = torch.cuda.max_memory_allocated()
    want = (len(names), len(FAT_POLICIES), 1, FAT_FLOWS)
    if tuple(result.cct.shape) != want:
        raise AssertionError(f"fat-tree: cct {tuple(result.cct.shape)}, expected {want}")
    if not bool(result.finished.all()):
        raise AssertionError(f"fat-tree: {int((~result.finished).sum())} flows did not finish")
    for (c, p, d), (run_s, run_folds, run_sprays, r) in sorted(runs.items()):
        ticks = int(r.ticks_run)
        cct = r.cct.cpu().numpy()
        print(f"[fat-tree] {names[c]} / {FAT_POLICIES[p]}: ticks {ticks}, "
              f"{1e3 * run_s / ticks:.4f} ms/tick, cct p50 {np.percentile(cct, 50)} p99 "
              f"{np.percentile(cct, 99)} max {cct.max()}, link_fold launches {run_folds}, "
              f"spray_select launches {run_sprays}")
        if run_folds < 2 * ticks or (FAT_POLICIES[p] == "WAM") != (run_sprays > 0):
            raise AssertionError(f"fat-tree {names[c]} / {FAT_POLICIES[p]}: the run did not "
                                 f"go through its kernels")
    rows["link_fold"]["launches"] += folds
    rows["spray_select"]["launches"] += sprays
    ser = series(frame_select(frame, (1, 1, 0)))
    for name, x in ser.items():
        if not np.isfinite(x).all():
            raise AssertionError(f"fat-tree: telemetry channel {name} is not finite")
    ticks = int(result.ticks_run.sum())
    print(f"[fat-tree] family of {len(names)} scenarios x {len(FAT_POLICIES)} policies x 1 draw "
          f"x {FAT_FLOWS} flows: {ticks} ticks in {secs:.3f} s ({1e3 * secs / ticks:.4f} ms/tick "
          f"with telemetry every {FAT_TELEMETRY['stride']}), peak memory {peak} B, cct digest "
          f"{_digest(result.cct)}; launches link_fold {folds}, spray_select {sprays}; "
          f"inter_pod_incast / WAM telemetry: {len(ser['tick'])} samples, hottest link queue "
          f"p99 {np.percentile(ser['link_queue'].max(axis=-1), 99)}")

    stride_tick_telemetry_waits(family["inter_pod_incast"][0], dev)
    print("[fat-tree] a stride tick's link telemetry and record at full width: no host wait "
          "(torch sync debug mode 'error')")

    # repeats of two slices: without telemetry, and with the plain spray
    spec_bare = dataclasses.replace(spec, telemetry=None)
    wam = sender.sender_params(Policy.WAM, rate=FAT_RATE)
    inc, flap = names.index("inter_pod_incast"), names.index("core_link_flap")
    topo, sched = family["inter_pod_incast"]
    bare = sender.run_flows(topo, sched, spec_bare, wam, FAT_PACKETS, keys[0], FAT_HORIZON,
                            device=dev)
    _equal_runs(bare, frame_select(result, (inc, 1, 0)),
                "inter_pod_incast / WAM without telemetry against its slice")
    topo, sched = family["core_link_flap"]
    plain = sender.run_flows(topo, sched, spec, wam, FAT_PACKETS, keys[0], FAT_HORIZON,
                             device=dev, plain_spray=True)
    _equal_runs(plain, (frame_select(result, (flap, 1, 0)), frame_select(frame, (flap, 1, 0))),
                "core_link_flap / WAM with the plain spray against its slice")
    print("[fat-tree] inter_pod_incast / WAM without telemetry and core_link_flap / WAM with "
          "the plain spray: every field equal to their slices of the sweep")

    # the card against the CPU at the CPU tests' sizes
    pols = [Policy[p] for p in SMALL_POLICIES]
    spec = sender.spec_for_policies(sender.SenderSpec(
        rate_cap=16, early_exit=True, telemetry=TelemetrySpec(**SMALL_TELEMETRY)), pols)
    sp = sender.policy_sweep_params(pols, rate=16)
    keys = prng.split(prng.PRNGKey(5), 2)
    for name, (topos, scheds) in _small_families().items():
        t0 = time.perf_counter()
        card = sender.sweep_flows_scenarios(topos, scheds, spec, sp, SMALL_PACKETS, keys,
                                            SMALL_HORIZON, device=dev)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = sender.sweep_flows_scenarios(topos, scheds, spec, sp, SMALL_PACKETS, keys,
                                           SMALL_HORIZON, device="cpu")
        _equal_runs(card, cpu, f"{name} family, the card against the CPU")
        print(f"[fat-tree] {name} family ({int(topos.route.shape[0])} scenarios x "
              f"{len(pols)} policies x 2 draws, {int(topos.route.shape[2])} flows, telemetry): "
              f"every field and frame leaf equal to the CPU run ({t_card:.1f} s on the card, "
              f"{time.perf_counter() - t0:.1f} s on the CPU)")
    return result


class _RunLog:
    """``on_run`` callback of the job and cluster sweeps: the
    card's time, ticks and kernel launches of every run, keyed by its sweep
    index (the card is synchronised after each run; the early-exit check
    waits for it every chunk already)."""

    def __init__(self):
        self.runs = {}
        self.last = None

    def start(self):
        torch.cuda.synchronize()
        spray_select.launches = link_fold.launches = 0
        self.last = (time.perf_counter(), 0, 0)

    def __call__(self, idx, out):
        torch.cuda.synchronize()
        now = time.perf_counter()
        r = out[0] if isinstance(out, tuple) else out
        self.runs[idx] = dict(s=now - self.last[0], ticks=int(r.ticks_run),
                              folds=link_fold.launches - self.last[1],
                              sprays=spray_select.launches - self.last[2], result=out)
        self.last = (now, link_fold.launches, spray_select.launches)

    def total(self, key, pick):
        """Sum of `key` over the runs whose index satisfies `pick`."""
        return sum(v[key] for k, v in self.runs.items() if pick(k))


def _check_kernels(log: _RunLog, policy_of, what):
    """Every run folded its links twice a tick; only WAM runs sprayed."""
    for idx, v in log.runs.items():
        wam = policy_of(idx) == "WAM"
        if v["folds"] < 2 * v["ticks"] or wam != (v["sprays"] > 0) and v["ticks"] > 0:
            raise AssertionError(f"{what} {idx}: the run did not go through its kernels "
                                 f"({v['ticks']} ticks, {v['folds']} link_fold, "
                                 f"{v['sprays']} spray_select launches)")


def job_step_waits(job, topo, sched, dev) -> None:
    """One job step on the card under torch's sync debug mode "error": the
    step (WAM, without early exit, whose chunk check is the one wait a run
    makes) raises if it copies to or from the host.  The step runs once
    before, as a run's first step builds the link CSR and loads the
    kernels."""
    spec = sender.SenderSpec(rate_cap=JOB_RATE)
    wam = sender.sender_params(Policy.WAM, rate=JOB_RATE)
    topo = sender.to_device(topo, dev)
    shard, _, offsets = jobs.step_table(job)
    scheds = jobs.scheduled_events(sched, offsets[:1], 64, device=dev)
    shard = torch.as_tensor(shard[:1], device=dev)
    key = prng.PRNGKey(0, device=dev)
    jobs.run_job_steps(topo, scheds, spec, wam, shard, key, 64, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cct, fin = jobs.run_job_steps(topo, scheds, spec, wam, shard, key, 64, device=dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if cct.shape != (1,) or not bool(torch.isfinite(cct).all()):
        raise AssertionError("jobs: the sync-checked step gave no barrier")


def _job_card_vs_cpu(dev):
    """The CPU tests' job sizes on the card and on the CPU: `sweep_job`
    over two job scenarios and the correlated spine outage, four policies
    (two stateful), two draws; then `run_job` with telemetry on one draw."""
    job = jobs.compile_job("qwen3-8b", workers=4, tp=8, iterations=1, rate=JOB_RATE,
                           max_shard=48)
    lib = dict(job_scenarios(workers=4, horizon=256))
    lib["srlg_spine_down"] = correlated_job_scenarios(workers=4, horizon=256)[
        "srlg_spine_down"]
    pols = [Policy[p] for p in SMALL_JOB_POLICIES]
    spec = sender.spec_for_policies(sender.SenderSpec(rate_cap=JOB_RATE, early_exit=True,
                                                      exit_chunk=JOB_EXIT_CHUNK), pols)
    sp = sender.policy_sweep_params(pols, rate=JOB_RATE)
    keys = prng.split(prng.PRNGKey(11), 2)
    t_card = t_cpu = 0.0
    for name in ("link_flap", "crossjob_background", "srlg_spine_down"):
        topo, sched = lib[name]
        out = {}
        for where in (dev, "cpu"):
            t0 = time.perf_counter()
            out[where] = jobs.sweep_job(topo, sched, spec, sp, [job], keys, SMALL_JOB_HORIZON,
                                        device=where)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            t_card, t_cpu = (t_card + dt, t_cpu) if where is dev else (t_card, t_cpu + dt)
        for k in ("cct", "finished", "ettr", "exposed"):
            a, b = out[dev][k], out["cpu"][k]
            if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError(f"jobs: sweep_job on {name}: {k} differs on the card")
    topo, sched = lib["link_flap"]
    tspec = dataclasses.replace(spec, telemetry=TelemetrySpec(**SMALL_JOB_TELEMETRY))
    wam = sender.sender_params(Policy.WAM, rate=JOB_RATE)
    runs = [jobs.run_job(topo, sched, tspec, wam, job, keys[0], SMALL_JOB_HORIZON, device=w)
            for w in (dev, "cpu")]
    for k in ("step_cct", "ettr", "exposed_comm_ticks", "finished"):
        if not np.array_equal(getattr(runs[0][0], k), getattr(runs[1][0], k)):
            raise AssertionError(f"jobs: run_job with telemetry: {k} differs on the card")
    _equal_runs(runs[0][1], runs[1][1], "jobs: run_job's frame, the card against the CPU")
    print(f"[jobs] sweep_job (link_flap, crossjob_background, srlg_spine_down x "
          f"{len(pols)} policies x 2 draws, {job.total_steps} steps) and run_job with "
          f"telemetry: every field and frame leaf equal to the CPU run ({t_card:.1f} s on "
          f"the card, {t_cpu:.1f} s on the CPU for the sweeps)")


def _cluster_card_vs_cpu(dev):
    """The CPU tests' cluster sizes on the card and on the CPU through
    `sweep_cluster_rounds_scenarios`: the overlapped and the staggered
    placements padded to one round count (the padded rounds all silent),
    and the correlated burst flaps (a grid of its own link count); then
    `sweep_ring_cct_shared` on a ring of 4."""
    js = [jobs.compile_job(a, workers=4, tp=8, iterations=1, rate=JOB_RATE, max_shard=48,
                           overlap={"allreduce": 0.0, "allgather": 0.0})
          for a in CLUSTER_ARCHS]
    pols = [Policy.ECMP, Policy.WAM]
    spec = sender.SenderSpec(rate_cap=JOB_RATE, early_exit=True, exit_chunk=JOB_EXIT_CHUNK)
    sp = sender.policy_sweep_params(pols, rate=JOB_RATE)
    keys = prng.split(prng.PRNGKey(4), 1)
    lib = cluster_scenarios(js, horizon=512)
    corr = correlated_cluster_scenarios(js, horizon=512)
    families = {"overlapped + staggered": [lib["rings_overlapped"], lib["staggered_start"]],
                "correlated burst_flaps": [corr["burst_flaps"]]}
    for name, scens in families.items():
        R = max(c.rounds for c, _, _ in scens)
        inputs = [cluster.cluster_inputs(c, s, SMALL_JOB_HORIZON, R) for c, _, s in scens]
        args = (stack_pytrees([t for _, t, _ in scens]), stack_pytrees([s for s, _ in inputs]),
                spec, sp, torch.stack([z for _, z in inputs]), keys, SMALL_JOB_HORIZON)
        t0 = time.perf_counter()
        card = cluster.sweep_cluster_rounds_scenarios(*args, device=dev)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = cluster.sweep_cluster_rounds_scenarios(*args, device="cpu")
        t_cpu = time.perf_counter() - t0
        for k in ("cct", "finished", "link_served", "link_busy"):
            a, b = card[k].cpu(), cpu[k]
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"cluster {name}: {k} differs on the card")
        print(f"[jobs] cluster {name} ({len(scens)} scenario(s) x 2 policies x {R} rounds x 3 "
              f"variants): every raw field equal to the CPU run ({t_card:.1f} s on the card, "
              f"{t_cpu:.1f} s on the CPU)")
    ring = collectives.ring_topology(4, uplink_capacity=4.0, degrade_p=0.01)
    ring_sched = null_schedule(ring.links)
    pols = [Policy.ECMP, Policy.WAM, Policy.CC_COUPLED]
    rspec = sender.spec_for_policies(sender.SenderSpec(rate_cap=16, early_exit=True,
                                                       exit_chunk=16), pols)
    rsp = sender.policy_sweep_params(pols, rate=16)
    rkeys = prng.split(prng.PRNGKey(8), 6)
    card = collectives.sweep_ring_cct_shared(ring, ring_sched, rspec, rsp, 48, rkeys, 256,
                                             device=dev)
    cpu = collectives.sweep_ring_cct_shared(ring, ring_sched, rspec, rsp, 48, rkeys, 256,
                                            device="cpu")
    for a, b, k in zip(card, cpu, ("per_step", "finished")):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"collectives: sweep_ring_cct_shared {k} differs on the card")
    print(f"[jobs] sweep_ring_cct_shared (ring of 4, 3 policies x 6 steps): equal to the CPU "
          f"run, per-step barriers {card[0].cpu().tolist()}")


def phase_jobs(dev, rows):
    # (a) the host: every arch's schedule through the cost model
    for arch in ARCH_IDS:
        job = jobs.compile_job(arch, workers=JOB_WORKERS, tp=JOB_TP, iterations=JOB_ITERATIONS,
                               rate=JOB_RATE, max_shard=JOB_MAX_SHARD)
        print(f"[jobs] {arch}: compute:comm {job.compute_comm_ratio:.4f}, shards "
              f"{[p.shard_packets for p in job.phases]}, {job.total_steps} steps, compute "
              f"{job.compute_ticks:.1f} ticks")

    # (b) the job cell at full width
    job = jobs.compile_job(JOB_ARCH, workers=JOB_WORKERS, tp=JOB_TP, iterations=JOB_ITERATIONS,
                           rate=JOB_RATE, max_shard=JOB_MAX_SHARD)
    lib = job_scenarios(workers=JOB_WORKERS, horizon=JOB_HORIZON)
    names = list(lib)
    inputs = [jobs.job_step_inputs([job], s, JOB_HORIZON, device=dev) for _, s in lib.values()]
    topos = stack_pytrees([sender.to_device(t, dev) for t, _ in lib.values()])
    scheds = stack_pytrees([s for s, _ in inputs])
    spec = sender.SenderSpec(rate_cap=JOB_RATE, early_exit=True, exit_chunk=JOB_EXIT_CHUNK)
    sp = sender.policy_sweep_params([Policy[p] for p in JOB_POLICIES], rate=JOB_RATE)
    keys = prng.split(prng.PRNGKey(0), 2)[:1]
    log = _RunLog()
    log.start()
    t0 = time.perf_counter()
    cct, fin = jobs.sweep_job_steps_scenarios(topos, scheds, spec, sp, inputs[0][1], keys,
                                              JOB_HORIZON, device=dev, on_run=log)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    folds, sprays = link_fold.launches, spray_select.launches
    want = (len(names), len(JOB_POLICIES), 1, 1, job.total_steps)
    if tuple(cct.shape) != want:
        raise AssertionError(f"jobs: cct {tuple(cct.shape)}, expected {want}")
    if not bool(fin.all()):
        raise AssertionError(f"jobs: {int((~fin).sum())} steps did not finish")
    _check_kernels(log, lambda idx: JOB_POLICIES[idx[1]], "jobs")
    rows["link_fold"]["launches"] += folds
    rows["spray_select"]["launches"] += sprays
    cct_np = cct.cpu().numpy()
    for c, name in enumerate(names):
        ettrs = []
        for p, pol in enumerate(JOB_POLICIES):
            ettr, exposed = jobs.job_ettr(job, cct_np[c, p, 0, 0])
            ettrs.append(float(ettr))
            pick = (lambda k, c=c, p=p: k[:2] == (c, p))
            ticks, run_s = log.total("ticks", pick), log.total("s", pick)
            print(f"[jobs] {name} / {pol}: ETTR {float(ettr):.6f}, exposed {float(exposed):.1f} "
                  f"ticks, {ticks} ticks run in {run_s:.3f} s ({1e3 * run_s / max(ticks, 1):.4f} "
                  f"ms/tick), spray_select launches {log.total('sprays', pick)}, link_fold "
                  f"launches {log.total('folds', pick)}")
        print(f"[jobs] {name}: WAM - ECMP ETTR margin {ettrs[1] - ettrs[0]:+.6f}")
    ticks = log.total("ticks", lambda k: True)
    digest = _digest(cct)
    print(f"[jobs] job cell ({JOB_ARCH}, {len(names)} scenarios x {len(JOB_POLICIES)} policies "
          f"x 1 draw x {job.total_steps} steps, horizon {JOB_HORIZON}): {ticks} ticks in "
          f"{secs:.3f} s ({1e3 * secs / ticks:.4f} ms/tick); launches link_fold {folds}, "
          f"spray_select {sprays}; cct digest {digest} (reference {JOB_DIGEST})")
    if digest != JOB_DIGEST:
        raise AssertionError(f"jobs: cct digest {digest} != the reference's {JOB_DIGEST}")

    # (d) WAM on link_flap with the plain spray against its slice of (b)
    c, p = names.index("link_flap"), JOB_POLICIES.index("WAM")
    plain_log = _RunLog()
    plain_log.start()
    topo, sched = lib["link_flap"]
    got = jobs.run_job_steps(topo, jobs.scheduled_events(sched, jobs.step_table(job)[2],
                                                         JOB_HORIZON, device=dev),
                             spec, sender.sender_params(Policy.WAM, rate=JOB_RATE),
                             inputs[0][1][0], keys[0], JOB_HORIZON, device=dev,
                             plain_spray=True, on_run=plain_log)
    if not (torch.equal(got[0], cct[c, p, 0, 0]) and torch.equal(got[1], fin[c, p, 0, 0])):
        raise AssertionError("jobs: link_flap / WAM with the plain spray differs from its slice")
    for (s,), v in plain_log.runs.items():
        _equal_runs(v["result"], log.runs[(c, p, 0, 0, s)]["result"],
                    f"jobs: link_flap / WAM step {s} with the plain spray")
    print("[jobs] link_flap / WAM with the plain spray: every step's every field equal to its "
          "slice of the sweep")
    job_step_waits(job, *lib["link_flap"], dev)
    print("[jobs] one job step on the card: no copy to or from the host (torch sync debug "
          "mode 'error')")

    # (c) the cluster cell at full width
    cjobs = [jobs.compile_job(a, workers=JOB_WORKERS, tp=JOB_TP, iterations=JOB_ITERATIONS,
                              rate=JOB_RATE, max_shard=CLUSTER_MAX_SHARD) for a in CLUSTER_ARCHS]
    clib = cluster_scenarios(cjobs, horizon=JOB_HORIZON)
    raws, folds, sprays = [], 0, 0
    for name in CLUSTER_SCENARIOS:
        placed, topo, sched = clib[name]
        log = _RunLog()
        log.start()
        t0 = time.perf_counter()
        res = cluster.sweep_cluster(topo, sched, spec, sp, placed, keys, CLUSTER_HORIZON,
                                    device=dev, on_run=log)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        folds, sprays = folds + link_fold.launches, sprays + spray_select.launches
        _check_kernels(log, lambda idx: JOB_POLICIES[idx[0]], f"cluster {name}")
        if not bool(np.all(res.finished)):
            raise AssertionError(f"cluster {name}: some round did not finish")
        R, V = placed.rounds, 1 + len(cjobs)
        # the raw cct [P, 1, V, R, F], from each run's result (on_run's
        # index is (policy, draw, round, variant))
        raw = torch.stack([log.runs[(p, 0, r, v)]["result"].cct
                           for p in range(len(JOB_POLICIES)) for v in range(V)
                           for r in range(R)]).reshape(len(JOB_POLICIES), 1, V, R, -1)
        raws.append(raw)
        for p, pol in enumerate(JOB_POLICIES):
            pick = (lambda k, p=p: k[0] == p)
            ticks, run_s = log.total("ticks", pick), log.total("s", pick)
            hot = res.link_util[p, 0].max()
            print(f"[jobs] cluster {name} / {pol}: ETTR {res.ettr[p, 0].round(6).tolist()}, "
                  f"solo {res.solo_ettr[p, 0].round(6).tolist()}, slowdown "
                  f"{res.slowdown[p, 0].round(6).tolist()}, Jain {res.jain[p, 0]:.6f}, hottest "
                  f"link utilisation {hot:.6f}; {ticks} ticks in {run_s:.3f} s "
                  f"({1e3 * run_s / max(ticks, 1):.4f} ms/tick)")
        print(f"[jobs] cluster {name}: {R} rounds x {V} variants x {len(JOB_POLICIES)} "
              f"policies in {secs:.3f} s")
    rows["link_fold"]["launches"] += folds
    rows["spray_select"]["launches"] += sprays
    digest = _digest(torch.stack(raws))
    print(f"[jobs] cluster cell: launches link_fold {folds}, spray_select {sprays}; cct digest "
          f"{digest} (reference {CLUSTER_DIGEST})")
    if digest != CLUSTER_DIGEST:
        raise AssertionError(f"cluster: cct digest {digest} != the reference's {CLUSTER_DIGEST}")

    # (e) the card against the CPU at the CPU tests' sizes
    _job_card_vs_cpu(dev)
    _cluster_card_vs_cpu(dev)


def _shard_job_cluster(mesh):
    """The CPU tests' job and cluster sweeps (tests/test_torch_shard_jobs.py):
    `sweep_job` over a ring of three workers on link_flap and `sweep_cluster`
    over two two-worker jobs one leaf a pod on a fat-tree, ECMP and WAM, on
    ``mesh`` or (``mesh=None``) unsharded on the CPU."""
    def job(workers):
        return jobs.compile_job("xlstm-350m", workers=workers, tp=8, iterations=1,
                                rate=SHARD_RATE, min_shard=16, max_shard=48,
                                overlap={"allreduce": 0.0, "allgather": 0.0})

    spec = sender.SenderSpec(rate_cap=SHARD_RATE, early_exit=True, exit_chunk=8)
    sp = sender.policy_sweep_params([Policy[p] for p in SHARD_POLICIES], rate=SHARD_RATE)
    where = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    topo, sched = job_scenarios(workers=3, horizon=SHARD_HORIZON)["link_flap"]
    job_out = jobs.sweep_job(topo, sched, spec, sp, [job(3)], prng.split(prng.PRNGKey(7), 1),
                             SHARD_HORIZON, **where)
    placed = cluster.place_jobs_pods([job(2)] * 2, leaves_per_pod=1)
    topo = cluster.cluster_fat_tree_topology(placed, leaves_per_pod=1)
    cluster_out = cluster.sweep_cluster(topo, null_schedule(topo.links), spec, sp, placed,
                                        prng.split(prng.PRNGKey(8), 1), SHARD_HORIZON, **where)
    return job_out, cluster_out


def _counted(what, ranks, fn):
    """``fn()`` with the kernels' launch counts set to 0 just before it; its
    seconds, ticks (link_fold launches / 2 a tick / ``ranks``) and launches
    printed; every rank folded its links twice a tick and sprayed (WAM)."""
    torch.cuda.synchronize()
    link_fold.launches = spray_select.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    folds, sprays = link_fold.launches, spray_select.launches
    ticks = folds // (2 * ranks)
    print(f"[shard] {what}: {secs:.3f} s, {ticks} ticks a rank ({1e3 * secs / max(ticks, 1):.4f} "
          f"ms a tick), launches link_fold {folds}, spray_select {sprays}")
    if not folds or not sprays or folds % (2 * ranks):
        raise AssertionError(f"shard {what}: the run did not go through its kernels")
    return out, secs, folds, sprays


def phase_shard(dev, rows, family_result):
    """Flow-sharded runs: (a) phase 5's fat-tree family over two gloo ranks
    sharing the card, equal to phase 5's unsharded result in every field;
    (b) the padded case on one NCCL rank, equal to the unsharded run on the
    card; (c) `sweep_job` / `sweep_cluster` over two ranks on the card at
    the CPU tests' sizes, equal to the unsharded runs on the CPU."""
    launches = {"link_fold": 0, "spray_select": 0}
    two = sender.flow_mesh(2, device=f"cuda:{torch.cuda.current_device()}")
    if two.backend != "gloo" or len(set(two.devices)) != 1:
        raise AssertionError(f"shard: {two} is not two gloo ranks on one card")

    # (a) the fat-tree family, as phase 5 runs it but without telemetry
    family = fat_family()
    topos, scheds = stack_scenarios(list(family.values()))
    spec = sender.SenderSpec(rate_cap=FAT_RATE, early_exit=True)
    sp = sender.policy_sweep_params([Policy[p] for p in FAT_POLICIES], rate=FAT_RATE)
    keys = prng.split(prng.PRNGKey(7), 1)
    got, secs, folds, sprays = _counted(
        f"(a) fat-tree family, {FAT_FLOWS} flows over 2 ranks", 2,
        lambda: sender.shard_sweep_flows_scenarios(topos, scheds, spec, sp, FAT_PACKETS, keys,
                                                   FAT_HORIZON, mesh=two))
    _equal_runs(family_result, got, "shard (a): the sharded family against phase 5's")
    digest = _digest(got.cct)
    if digest != FAT_DIGEST:
        raise AssertionError(f"shard (a): cct digest {digest}, the reference's {FAT_DIGEST}")
    ticks = int(got.ticks_run.sum())
    print(f"[shard] (a) every field equal to phase 5's unsharded run; {ticks} ticks "
          f"({got.ticks_run.flatten().tolist()}), {1e3 * secs / ticks:.4f} ms a tick, cct "
          f"digest {digest}")
    launches["link_fold"] += folds
    launches["spray_select"] += sprays

    # (b) the padded case on one NCCL rank
    one = sender.flow_mesh(1)
    if one.backend != "nccl":
        raise AssertionError(f"shard: {one} is not one NCCL rank")
    topo = leaf_spine(4, 2, SHARD_PAIRS)
    args = (topo, null_schedule(topo.links),
            sender.SenderSpec(rate_cap=SHARD_RATE, early_exit=True, exit_chunk=16),
            sender.sender_params(Policy.WAM, rate=SHARD_RATE),
            torch.tensor(SHARD_SIZES, dtype=torch.int32), prng.PRNGKey(4), SHARD_HORIZON)
    got, _, folds, sprays = _counted("(b) five flows, one of size 0, on one NCCL rank", 1,
                                     lambda: sender.shard_run_flows(*args, mesh=one))
    _equal_runs(sender.run_flows_sized(*args, device=dev), got,
                "shard (b): one NCCL rank against the unsharded run")
    print("[shard] (b) every field equal to the unsharded run on the card")
    launches["link_fold"] += folds
    launches["spray_select"] += sprays

    # (c) the job and cluster sweeps over two ranks, the card against the CPU
    (job_card, cluster_card), _, folds, sprays = _counted(
        "(c) sweep_job and sweep_cluster over 2 ranks", 2, lambda: _shard_job_cluster(two))
    t0 = time.perf_counter()
    job_cpu, cluster_cpu = _shard_job_cluster(None)
    for k in job_cpu:
        if not np.array_equal(job_cpu[k], job_card[k]) or job_cpu[k].dtype != job_card[k].dtype:
            raise AssertionError(f"shard (c): sweep_job {k} differs from the CPU's")
    for f in dataclasses.fields(cluster_cpu):
        if f.name == "cluster":
            continue
        a, b = getattr(cluster_cpu, f.name), getattr(cluster_card, f.name)
        if f.name == "step_cct":
            a, b = np.stack(a), np.stack(b)
        if not np.array_equal(a, b) or a.dtype != b.dtype:
            raise AssertionError(f"shard (c): sweep_cluster {f.name} differs from the CPU's")
    print(f"[shard] (c) sweep_job and every sweep_cluster metric equal to the unsharded CPU "
          f"runs ({time.perf_counter() - t0:.1f} s on the CPU)")
    launches["link_fold"] += folds
    launches["spray_select"] += sprays
    for name, n in launches.items():
        rows[name]["launches"] += n
    print(f"[shard] launches in the phase: link_fold {launches['link_fold']}, spray_select "
          f"{launches['spray_select']}")


def _same_decode(a, b, what):
    if (a is None) != (b is None) or (a is not None and not np.array_equal(a, b)):
        raise AssertionError(f"{what}: the card's decode differs from the CPU's")
    return "None (not decodable)" if a is None else "decoded"


def phase_coded(dev, rows, message):
    payload, neigh, valid = message
    K, R = CODED_K, CODED_R
    lt_encode.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc_dev = fountain.encode(payload, neigh, valid, device=dev)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    enc = fountain.as_uint32(enc_dev)
    t0 = time.perf_counter()
    enc_cpu = fountain.as_uint32(fountain.encode(payload, neigh, valid, device="cpu"))
    t_cpu = time.perf_counter() - t0
    if not np.array_equal(enc, enc_cpu):
        raise AssertionError("coded: the card's encoding differs from the CPU's")
    print(f"[coded] encoded {K} x {CODED_P * 4} B -> {R} symbols: {1e3 * t_enc:.3f} ms on the "
          f"card (host copy in, kernel), {1e3 * t_cpu:.3f} ms on the CPU; equal")
    keep = np.sort(np.random.default_rng(1).permutation(R)[: int(0.9 * R)])
    for name, idx in (("all", np.arange(R)), ("90%", keep)):
        t0 = time.perf_counter()
        got = fountain.peel_decode(enc[idx], neigh[idx], valid[idx], K)
        t_dec = time.perf_counter() - t0
        want = fountain.peel_decode(enc_cpu[idx], neigh[idx], valid[idx], K)
        state = _same_decode(got, want, f"decode of {name} {idx.size} symbols")
        if got is not None and not np.array_equal(got, payload):
            raise AssertionError(f"decode of {name} symbols gave a wrong payload")
        print(f"[coded] peel decode of {name} ({idx.size}) symbols: {state}, "
              f"{1e3 * t_dec:.1f} ms on the host; equal to the CPU run")
    rng = np.random.default_rng(0)
    small = rng.integers(0, 2**32, (256, CODED_P), dtype=np.uint32)
    nb, ok = fountain.sample_encoding(256, 441, rng)
    dec = fountain.peel_decode(fountain.as_uint32(fountain.encode(small, nb, ok, device=dev)),
                               nb, ok, 256)
    if dec is None or not np.array_equal(dec, small):
        raise AssertionError("coded: the K = 256 round trip did not return the payload")
    print("[coded] round trip K = 256, P = 1024, R = 441: decoded to the payload")
    for k, trials in ((256, 8), (1024, 3)):
        got = fountain.decode_overhead_curve(k, trials, np.random.default_rng(3), device=dev)
        want = fountain.decode_overhead_curve(k, trials, np.random.default_rng(3), device="cpu")
        if not np.array_equal(got, want):
            raise AssertionError(f"decode_overhead_curve({k}) differs: {got} != {want}")
        r_full = int(k * 1.6) + 32
        print(f"[coded] decode_overhead_curve({k}, {trials}): {got.tolist()}, equal to the CPU "
              f"run; {int((got == r_full).sum())} of {trials} censored at R = {r_full}")
    launches = lt_encode.launches
    if launches <= 0:
        raise AssertionError("the coded path never launched lt_encode")
    rows["lt_encode"]["launches"] = launches
    print(f"[coded] lt_encode launches on the coded path: {launches}")


def run_router(device):
    """200 windows of simulate_window + report; everything they return."""
    weights = 0.5 + 1.5 * np.random.default_rng(0).random(ROUTER_REPLICAS)
    router = Router(weights, ell=10, device=device)
    rng = np.random.default_rng(0)
    out = []
    for window in range(ROUTER_WINDOWS):
        service = np.full(ROUTER_REPLICAS, 5.0)
        if 50 <= window < 120:
            service[ROUTER_SLOW] *= 8.0
        rep = router.simulate_window(ROUTER_BATCH, service, rng)
        w = router.report(rep)
        out.append((router.last_ids, router.last_seqs, w, router.shares))
    return out


def phase_router(dev, rows):
    spray_select.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = run_router(dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = spray_select.launches
    cpu = run_router("cpu")
    for window, (a, b) in enumerate(zip(card, cpu)):
        for field, x, y in zip(("ids", "sequence numbers", "weights", "shares"), a, b):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"router window {window}: {field} differ from the CPU run")
    if launches < ROUTER_WINDOWS:
        raise AssertionError(f"the router launched spray_select {launches} times")
    rows["spray_select"]["launches"] += launches
    slow = np.array([c[3][ROUTER_SLOW] for c in card])
    spans = ((0, 50), (50, 120), (120, ROUTER_WINDOWS))
    print(f"[router] {ROUTER_REPLICAS} replicas x {ROUTER_WINDOWS} windows of {ROUTER_BATCH}: "
          f"{1e3 * secs / ROUTER_WINDOWS:.4f} ms per window on the card, spray_select launches "
          f"{launches}; slow replica's mean share in windows "
          + ", ".join(f"[{a}, {b}) {slow[a:b].mean():.6f}" for a, b in spans)
          + "; ids, sequence numbers, weights and shares equal to the CPU run")

# flash_attention cases (B, H, KVH, Sq, Sk, D, causal, window, q_offset): the
# CPU tests' sweep, q_offset, ragged and windowed shapes, head dims 16 to 256
ATTN_CASES = (
    (2, 4, 2, 256, 256, 64, True, None, 0), (1, 8, 8, 128, 128, 128, False, None, 0),
    (2, 4, 1, 256, 256, 64, True, 64, 0), (1, 2, 2, 512, 512, 32, True, 128, 0),
    (1, 2, 2, 64, 128, 32, True, None, 64), (2, 4, 2, 48, 48, 16, True, 32, 0),
    (1, 8, 2, 37, 53, 120, True, None, 16), (2, 4, 4, 17, 64, 64, False, None, 0),
    (1, 4, 1, 33, 33, 128, True, 8, 0), (1, 2, 1, 16, 16, 16, True, None, -8),
    (2, 32, 8, 300, 300, 120, True, 100, 0), (1, 2, 1, 70, 70, 256, True, 20, 0),
    # a head dim the wgmma route copies (40-byte rows), and key counts that
    # are not a multiple of the key tile (128 keys; 64 at D = 256)
    (2, 4, 2, 48, 48, 20, True, None, 0), (1, 4, 2, 200, 333, 128, True, None, 133),
    (1, 2, 1, 100, 1000, 256, False, None, 0),
)
# flash_attention at the zoo's shapes (name, B, H, KVH, Sq, Sk, D, causal,
# window), bf16 in the model's layout: whisper-large-v3's encoder over its
# 1,500 frames (non-causal, D 64) and its cross-attention (384 queries over
# 1,500 keys), starcoder2-3b's group of 12 with its 4,096 window over 8,192
# keys (the band cuts), arctic-480b's group of 7
ZOO_ATTN_CASES = (
    ("whisper encoder", 4, 20, 20, 1500, 1500, 64, False, None),
    ("whisper cross-attention", 4, 20, 20, 384, 1500, 64, False, None),
    ("starcoder2 group 12, window 4096", 1, 24, 2, 8192, 8192, 128, True, 4096),
    ("arctic group 7", 4, 56, 8, 2048, 2048, 128, True, None),
)
# flash_decode cases (B, H, KVH, Sk, D): the CPU tests' sweep and edges, and
# the zoo's groups of 6 (dbrx-132b), 7 (arctic-480b) and 12 (starcoder2-3b's
# 4,096-slot window cache)
DECODE_CASES = ((3, 8, 2, 1024, 64), (2, 4, 4, 512, 128), (1, 16, 2, 2048, 64),
                (2, 8, 2, 56, 16), (2, 8, 2, 100, 120), (3, 8, 2, 64, 64),
                (2, 32, 8, 4096, 128), (1, 16, 1, 300, 256),
                (4, 48, 8, 2112, 128), (4, 56, 8, 2112, 128), (4, 24, 2, 4096, 128))
# whisper-large-v3's cross-attention decode: 1,500 encoder slots at D 64,
# every row full
XATTN_DECODE = (4, 20, 20, 1500, 64)


def _randn(g, shape, dtype, dev):
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _check_close(got, want, tol, what):
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"{what}: max |diff| {err} beyond atol = rtol = {tol}")
    return err


def _timings(name, calls, plain_iters):
    """Graph-replayed and eager ms per call of each entry of ``calls``."""
    graphed, eager = {}, {}
    for key, fn in calls.items():
        iters = plain_iters if key == "plain" else 20
        graphed[key] = device_ms(fn, iters=iters)
        eager[key] = time_ms(fn, iters=iters, warmup=2)
    print(f"[kernels] {name} graph-replayed ms per call: "
          + ", ".join(f"{k} {v:.6f}" for k, v in graphed.items()))
    print(f"[kernels] {name} eager ms per call: "
          + ", ".join(f"{k} {v:.6f}" for k, v in eager.items()))
    return graphed


def _attn_case(name, q, k, v, kw, tol):
    """One flash_attention call against its plain version, with its route
    and the wrapper's aligning copies printed."""
    before = flash_attention.copies
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err = _check_close(got, flash_attention_plain(q, k, v, **kw), tol,
                       f"flash_attention {name} {kw}")
    print(f"[kernels] flash_attention {name} {kw}: route {plan(q, k, v).route}, copies "
          f"{flash_attention.copies - before}, max |diff| {err}")


def phase_flash_attention(dev):
    """flash_attention against its plain version; returns the kernel's row
    (the bf16 route at the prefill shape)."""
    g = torch.Generator(device=dev).manual_seed(2)
    checked = 0
    for dtype, tol in FLASH_TOL.items():
        for B, H, KVH, Sq, Sk, D, causal, window, q_offset in ATTN_CASES:
            q = _randn(g, (B, H, Sq, D), dtype, dev)
            k, v = (_randn(g, (B, KVH, Sk, D), dtype, dev) for _ in range(2))
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            _attn_case(f"{str(dtype)[6:]} {(B, H, KVH, Sq, Sk, D)}", q, k, v, kw, tol)
            checked += 1
        # a view whose base is 2 bytes past a 16-byte boundary: TMA cannot
        # read it, so the wgmma route copies it first
        B, H, KVH, S, D = 2, 4, 2, 96, 64
        flat = _randn(g, (B * H * S * D + 1,), dtype, dev)
        q = flat[1:].view(B, H, S, D)
        k, v = (_randn(g, (B, KVH, S, D), dtype, dev) for _ in range(2))
        _attn_case(f"{str(dtype)[6:]} {(B, H, KVH, S, S, D)}, q misaligned", q, k, v,
                   dict(causal=True, window=None, q_offset=0), tol)
        # q, k, v with a head-dim stride of S: transposed views of [B, heads,
        # D, S] tensors, which both routes copy; the output keeps a unit stride
        q = _randn(g, (B, H, D, S), dtype, dev).transpose(2, 3)
        k, v = (_randn(g, (B, KVH, D, S), dtype, dev).transpose(2, 3) for _ in range(2))
        _attn_case(f"{str(dtype)[6:]} {(B, H, KVH, S, S, D)}, head dim strided", q, k, v,
                   dict(causal=True, window=None, q_offset=0), tol)
        checked += 2
    for name, B, H, KVH, Sq, Sk, D, causal, window in ZOO_ATTN_CASES:
        q = _randn(g, (B, Sq, H, D), torch.bfloat16, dev).transpose(1, 2)
        k, v = (_randn(g, (B, Sk, KVH, D), torch.bfloat16, dev).transpose(1, 2)
                for _ in range(2))
        if any(plan(q, k, v).copy):
            raise AssertionError(f"flash_attention {name}: the model's layout is copied")
        _attn_case(f"{name} {(B, H, KVH, Sq, Sk, D)}", q, k, v,
                   dict(causal=causal, window=window, q_offset=0), FLASH_TOL[torch.bfloat16])
        checked += 1
        del q, k, v
    # the main path's prefill shape, and the model's layout: q, k, v are
    # transposed views of [B, S, heads, D] projections
    cfg = get_config(DENSE_ARCH)
    B, S, H, KVH, D = DENSE_BATCH, DENSE_PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _randn(g, (B, S, H, D), torch.bfloat16, dev).transpose(1, 2)
    k, v = (_randn(g, (B, S, KVH, D), torch.bfloat16, dev).transpose(1, 2) for _ in range(2))
    how = plan(q, k, v)
    if how.route != "wgmma" or any(how.copy):
        raise AssertionError(f"flash_attention at full width: {how}")
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v)
    err = _check_close(got, want, FLASH_TOL[torch.bfloat16], "flash_attention at full width")
    del want
    print(f"[kernels] flash_attention equals its plain version in {checked + 1} cases "
          f"(max |diff| at full width {err}, {how})")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    graphed = _timings("flash_attention", {
        "kernel": lambda: flash_attention(q, k, v),
        "kernel with lse": lambda: flash_attention_with_lse(q, k, v),
        "plain": lambda: flash_attention_plain(q, k, v),
        "sdpa": lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                       enable_gqa=True),
    }, plain_iters=3)
    qf, kf, vf = q.float(), k.float(), v.float()
    f32_ms = device_ms(lambda: flash_attention(qf, kf, vf), iters=3)
    print(f"[kernels] flash_attention f32 route ({plan(qf, kf, vf).route}) at the same shape: "
          f"{f32_ms:.6f} ms graph-replayed")
    del qf, kf, vf
    # the bound: each visible (query, key) pair costs 4 D flops (QK and PV);
    # q, k, v read once and o written once
    pairs = B * H * S * (S + 1) // 2
    ops = 4 * D * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[kernels] flash_attention [B {B}, H {H}, KVH {KVH}, S {S}, D {D}, bf16, causal, "
          f"route {how.route}]: {ops} flops -> {t_ops:.6f} ms, {nbytes} B -> {t_bytes:.6f} ms; "
          f"kernel {graphed['kernel']:.6f} ms ({ops / graphed['kernel'] / 1e9:.1f} TFLOP/s, "
          f"{100 * max(t_bytes, t_ops) / graphed['kernel']:.1f}% of the bound), plain "
          f"{graphed['plain']:.6f} ms, sdpa {graphed['sdpa']:.6f} ms, bound "
          f"{max(t_bytes, t_ops):.6f} ms ({bound_by})")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:92", launches=0,
                max_abs_err=err, ms=graphed["kernel"], plain_ms=graphed["plain"],
                bound_ms=max(t_bytes, t_ops), bound_by=bound_by, library_ms=graphed["sdpa"])


# flash_attention's backward (B, H, KVH, Sq, Sk, D, causal, window,
# q_offset): the CPU tests' shapes (tests/test_torch_attention_grad.py),
# both dtypes
BWD_CASES = (
    (2, 4, 4, 32, 32, 16, True, None, 0), (1, 4, 1, 24, 40, 32, False, None, 0),
    (2, 4, 1, 48, 48, 32, True, 8, 0), (1, 7, 1, 20, 20, 20, True, None, 0),
    (1, 14, 2, 16, 37, 20, True, 12, 21), (1, 8, 2, 20, 36, 16, True, None, 16),
    (1, 2, 1, 16, 16, 16, True, None, -8), (1, 4, 2, 16, 16, 24, True, 4, -6),
)
# and in bf16 in the model's layout: the zoo's shapes (ZOO_ATTN_CASES) and
# arctic's group of 7 at D 20 (name, B, H, KVH, Sq, Sk, D, causal, window)
ZOO_BWD_CASES = ZOO_ATTN_CASES + (("group 7, D 20", 2, 14, 2, 333, 333, 20, True, None),)


def _bwd_case(name, q, k, v, kw, tol):
    """The forward's lse against the plain version's (its output bit-equal
    to the call without lse), then the backward kernel against its plain
    version on the same inputs: one launch a call, two calls bit-equal.
    Returns (max |diff|, the inputs)."""
    o, lse = flash_attention_with_lse(q, k, v, **kw)
    if not torch.equal(o, flash_attention(q, k, v, **kw)):
        raise AssertionError(f"flash_attention {name}: the output with lse differs")
    want_lse = _attention_lse_plain(q, k, v, kw)
    if not torch.equal(torch.isinf(lse), torch.isinf(want_lse)):
        raise AssertionError(f"flash_attention {name}: lse's empty rows differ")
    fin = torch.isfinite(want_lse)
    lse_err = _check_close(lse[fin], want_lse[fin], 1e-4, f"flash_attention {name} lse")
    del want_lse
    g = torch.Generator(device=q.device).manual_seed(q.numel() % 1000)
    do = _randn(g, tuple(o.shape), q.dtype, q.device).as_strided(o.shape, o.stride())
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    if flash_attention_bwd.launches != before + 2:
        raise AssertionError(f"flash_attention_bwd {name}: not one launch a call")
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    err = 0.0
    for part, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
        if not torch.equal(a, c):
            raise AssertionError(f"flash_attention_bwd {name}: two calls differ in {part}")
        err = max(err, _check_close(a, b, tol, f"flash_attention_bwd {name} {kw} {part}"))
    print(f"[kernels] flash_attention_bwd {name} {kw}: lse max |diff| {lse_err}, dq / dk / dv "
          f"max |diff| {err}, two calls bit-equal")
    return err, (o, lse, do)


def _attention_lse_plain(q, k, v, kw):
    """The rows' log-sum-exp of the plain quadratic form."""
    from repro_torch.kernels.flash_attention import _plain

    return _plain(q, k, v, kw["causal"], kw["window"], None, kw["q_offset"], True)[1]


# the backward's launches, by the kernel names of both sources
BWD_LAUNCHES = {"delta_kernel": "delta", "dkdv_kernel": "dK / dV", "dq_kernel": "dQ"}


def bwd_launch_shares(fn, calls: int = 5) -> dict:
    """Device ms a call of each of the backward's launches over ``calls``
    calls of ``fn`` (`torch.profiler`); fails when one is missing."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(BWD_LAUNCHES.values(), 0.0)
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        for kernel, name in BWD_LAUNCHES.items():
            if f"{kernel}<" in e.key or f"{kernel}(" in e.key:
                ms[name] += float(us) / 1e3 / calls
    if not all(ms.values()):
        raise AssertionError(f"torch.profiler missed a backward launch: {ms}")
    return ms


def phase_flash_attention_bwd(dev):
    """flash_attention's gradient kernel (and the forward's lse) against the
    plain versions; returns the backward's row (bf16 at the train shape)."""
    g = torch.Generator(device=dev).manual_seed(3)
    checked = 0
    for dtype, tol in BWD_TOL.items():
        for B, H, KVH, Sq, Sk, D, causal, window, q_offset in BWD_CASES:
            q = _randn(g, (B, H, Sq, D), dtype, dev)
            k, v = (_randn(g, (B, KVH, Sk, D), dtype, dev) for _ in range(2))
            _bwd_case(f"{str(dtype)[6:]} {(B, H, KVH, Sq, Sk, D)}", q, k, v,
                      dict(causal=causal, window=window, q_offset=q_offset), tol)
            checked += 1
    for name, B, H, KVH, Sq, Sk, D, causal, window in ZOO_BWD_CASES:
        q = _randn(g, (B, Sq, H, D), torch.bfloat16, dev).transpose(1, 2)
        k, v = (_randn(g, (B, Sk, KVH, D), torch.bfloat16, dev).transpose(1, 2)
                for _ in range(2))
        _bwd_case(f"{name} {(B, H, KVH, Sq, Sk, D)}", q, k, v,
                  dict(causal=causal, window=window, q_offset=0), BWD_TOL[torch.bfloat16])
        checked += 1
        del q, k, v
        torch.cuda.empty_cache()
    # the train shape, in the model's layout (q, k, v and o transposed views
    # of [B, S, heads, D]; do laid out like o, as autograd hands it over)
    cfg = get_config(TRAIN_ARCH)
    B, S, H, KVH, D = TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _randn(g, (B, S, H, D), torch.bfloat16, dev).transpose(1, 2)
    k, v = (_randn(g, (B, S, KVH, D), torch.bfloat16, dev).transpose(1, 2) for _ in range(2))
    kw = dict(causal=True, window=None, q_offset=0)
    copies = flash_attention_bwd.copies
    err, (o, lse, do) = _bwd_case(f"train shape {(B, H, KVH, S, S, D)}", q, k, v, kw,
                                  BWD_TOL[torch.bfloat16])
    if flash_attention_bwd.copies != copies:
        raise AssertionError("flash_attention_bwd at the train shape copied an operand")
    checked += 1
    print(f"[kernels] flash_attention_bwd equals its plain version in {checked} cases, each "
          f"twice bit for bit")
    how = bwd_plan(q, k, v, o, do)
    if how.route != "wgmma" or any(how.copy):
        raise AssertionError(f"flash_attention_bwd at the train shape: {how}")
    # SDPA's backward alone, on contiguous copies (a yardstick: the port
    # never calls it); its forward runs on a side stream, where autograd
    # then runs the backward, so that the backward can be captured in a
    # graph on that stream as the kernel is
    qs, ks, vs = (t.contiguous().requires_grad_() for t in (q, k, v))
    dos = do.contiguous()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    torch.cuda.current_stream().wait_stream(side)

    def kernel():
        return flash_attention_bwd(q, k, v, o, lse, do)

    def sdpa():
        return torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True)

    graphed = {
        "kernel": device_ms(kernel, iters=5),
        "plain": device_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do), iters=2),
        "sdpa": device_ms(sdpa, iters=5, stream=side),
    }
    eager = {name: time_ms(fn, iters=20, warmup=3) for name, fn in (("kernel", kernel),
                                                                    ("sdpa", sdpa))}
    print("[kernels] flash_attention_bwd ms per call, graph-replayed: "
          + ", ".join(f"{k} {v:.6f}" for k, v in graphed.items()) + "; eager on events: "
          + ", ".join(f"{k} {v:.6f}" for k, v in eager.items()))
    del out, qs, ks, vs, dos
    shares = bwd_launch_shares(kernel)
    total = sum(shares.values())
    print("[kernels] flash_attention_bwd launches at the train shape (torch.profiler, ms a "
          "call): " + ", ".join(f"{k} {v:.6f} ({100 * v / total:.1f}%)"
                                for k, v in shares.items()))
    # the bound: dP and S recomputed, dV, dK and dQ: 5 products of 2 D flops
    # per visible (query, key) pair, S**2 / 2 pairs per (b, h); q, k, v, o,
    # do and lse read once, dq, dk and dv written once.  The design's own
    # floor: 7 products (S and dP again in the dQ launch)
    ops = 5 * 2 * D * (S * S // 2) * B * H
    ops7 = 7 * 2 * D * (S * S // 2) * B * H
    nbytes = 2 * (3 * q.numel() + 2 * k.numel() + 2 * v.numel() + o.numel()) + 4 * lse.numel()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[kernels] flash_attention_bwd [B {B}, H {H}, KVH {KVH}, S {S}, D {D}, bf16, causal, "
          f"route {how.route}]: {ops} flops -> {t_ops:.6f} ms, {nbytes} B -> {t_bytes:.6f} ms; "
          f"the design's 7 products {ops7} flops -> {ops7 / BF16_OPS_PER_S * 1e3:.6f} ms; "
          f"kernel {graphed['kernel']:.6f} ms ({ops / graphed['kernel'] / 1e9:.1f} TFLOP/s, "
          f"{100 * max(t_bytes, t_ops) / graphed['kernel']:.1f}% of the bound), plain "
          f"{graphed['plain']:.6f} ms, sdpa backward {graphed['sdpa']:.6f} ms, bound "
          f"{max(t_bytes, t_ops):.6f} ms ({bound_by})")
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="src/repro/kernels/ref.py:97", launches=0, max_abs_err=err,
                ms=graphed["kernel"], plain_ms=graphed["plain"], bound_ms=max(t_bytes, t_ops),
                bound_by=bound_by, library_ms=graphed["sdpa"])


def _decode_inputs(g, B, H, KVH, Sk, D, dtype, dev):
    q = _randn(g, (B, H, D), dtype, dev)
    k, v = (_randn(g, (B, Sk, KVH, D), dtype, dev) for _ in range(2))
    kv_len = torch.randint(1, Sk + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    return q, k, v, kv_len


def _decode_edges(g, dev):
    """flash_decode's cases beyond DECODE_CASES; returns how many: an int64
    kv_len out of [0, Sk]; the model's layer slice of a stacked cache (read
    in place) and a view TMA cannot read (one counted copy); three CUDA-graph
    replays of one call (the arrival counters reset)."""
    q, k, v, _ = _decode_inputs(g, 4, 8, 2, 300, 64, torch.bfloat16, dev)
    kv_len = torch.tensor([-5, 400, 2**40, 77], dtype=torch.int64, device=dev)
    got = flash_decode(q, k, v, kv_len, return_lse=True)
    for a, b in zip(got, flash_decode_plain(q, k, v, kv_len.clamp(0, 300))):
        _check_close(a, b, 2e-5, "flash_decode, int64 kv_len out of [0, Sk]")
    if not (got[1][0] == -1e30).all() or got[2][0].any():
        raise AssertionError("flash_decode: a negative kv_len is not an empty row")
    cfg = get_config(DENSE_ARCH)
    B, H, KVH, D = DENSE_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cache = _randn(g, (3, B, 200, KVH, D), torch.bfloat16, dev)
    q = _randn(g, (B, H, D), torch.bfloat16, dev)
    kv_len = torch.tensor([200, 3, 150, 64], dtype=torch.int32, device=dev)
    flat = _randn(g, (cache[0].numel() + 1,), torch.bfloat16, dev)
    views = {"stacked-cache slice": (cache[1], cache[2], 0),
             "k 2 bytes past a 16-byte boundary": (flat[1:].view(cache[0].shape), cache[2], 1)}
    for name, (k, v, copies) in views.items():
        before = flash_decode.copies
        got = flash_decode(q, k, v, kv_len, return_lse=True)
        for a, b in zip(got, flash_decode_plain(q, k, v, kv_len)):
            _check_close(a, b, 2e-5, f"flash_decode, {name}")
        if flash_decode.copies - before != copies:
            raise AssertionError(f"flash_decode, {name}: {flash_decode.copies - before} copies, "
                                 f"expected {copies}")
        print(f"[kernels] flash_decode {name}: plan {decode_plan(k, v)}, copies {copies}")
    q, k, v, kv_len = _decode_inputs(g, B, H, KVH, DENSE_PROMPT + DENSE_GEN, D, torch.bfloat16,
                                     dev)
    kv_len = kv_len.to(torch.int64)
    eager = flash_decode(q, k, v, kv_len)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode(q, k, v, kv_len)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, eager):
            raise AssertionError("flash_decode: a graph replay differs from the eager call")
    print("[kernels] flash_decode: 3 graph replays equal the eager call bit for bit")
    return 4


def _decode_case(g, dtype, tol, B, H, KVH, Sk, D, dev, full=False):
    """One cache shape against the plain version: the partials at 2e-5, the
    output at ``tol`` and bit-equal to `normalise` of the partials, an empty
    row's partials, one launch a call.  kv_len is drawn, with its last row
    full, its first empty and its second of one slot; ``full`` fills every
    row."""
    q, k, v, kv_len = _decode_inputs(g, B, H, KVH, Sk, D, dtype, dev)
    kv_len[-1] = Sk
    empty = B > 1 and not full
    if full:
        kv_len.fill_(Sk)
    elif B > 1:
        kv_len[0] = 0
    if B > 2 and not full:
        kv_len[1] = 1
    what = f"flash_decode {dtype} {(B, H, KVH, Sk, D)} kv_len {kv_len.tolist()}"
    before = flash_decode.launches
    o, m, l = flash_decode(q, k, v, kv_len, return_lse=True)
    out = flash_decode(q, k, v, kv_len)
    po, pm, pl = flash_decode_plain(q, k, v, kv_len)
    torch.cuda.synchronize()
    for got, want in ((o, po), (m, pm), (l, pl)):
        _check_close(got, want, 2e-5, what)
    if empty and (not (m[0] == -1e30).all() or l[0].any() or o[0].any()):
        raise AssertionError(f"{what}: an empty row's (m, l, o) is not (-1e30, 0, 0)")
    _check_close(out, normalise(po, pl, dtype), tol, what)
    if not torch.equal(out, normalise(o, l, dtype)):
        raise AssertionError(f"{what}: the output is not `normalise` of the partials")
    if flash_decode.launches != before + 2:
        raise AssertionError(f"{what}: {flash_decode.launches - before} launches, 2 calls")


def phase_flash_decode(dev):
    """flash_decode against its plain version; returns the kernel's row."""
    g = torch.Generator(device=dev).manual_seed(3)
    checked = 0
    for dtype, tol in FLASH_TOL.items():
        for B, H, KVH, Sk, D in DECODE_CASES:
            _decode_case(g, dtype, tol, B, H, KVH, Sk, D, dev)
            checked += 1
        _decode_case(g, dtype, tol, *XATTN_DECODE, dev, full=True)
        checked += 1
    checked += _decode_edges(g, dev)
    # the main path's decode shape: the cache of 2,048 + 64 slots, all valid
    cfg = get_config(DENSE_ARCH)
    B, Sk, H, KVH, D = (DENSE_BATCH, DENSE_PROMPT + DENSE_GEN, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim)
    q, k, v, kv_len = _decode_inputs(g, B, H, KVH, Sk, D, torch.bfloat16, dev)
    kv_len.fill_(Sk)
    got = flash_decode(q, k, v, kv_len)
    po, _, pl = flash_decode_plain(q, k, v, kv_len)
    want = normalise(po, pl, torch.bfloat16)
    err = _check_close(got, want, FLASH_TOL[torch.bfloat16], "flash_decode at full width")
    print(f"[kernels] flash_decode equals its plain version in {checked + 1} cases "
          f"(max |diff| at full width {err})")
    qs = q[:, :, None]
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(Sk, device=dev)[None, :] < kv_len[:, None])[:, None, None, :]
    graphed = _timings("flash_decode", {
        "kernel": lambda: flash_decode(q, k, v, kv_len),
        "plain": lambda: flash_decode_plain(q, k, v, kv_len),
        "sdpa": lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                       enable_gqa=True),
    }, plain_iters=20)
    # the bound: q and the kv_len valid cache rows read once, (o, m, l)
    # written once; 4 D flops per (query head, valid slot)
    valid = int(kv_len.sum())
    nbytes = 2 * q.numel() + 2 * 2 * valid * KVH * D + 4 * B + 4 * (B * H * D + 2 * B * H)
    ops = 4 * H * D * valid
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[kernels] flash_decode [B {B}, H {H}, KVH {KVH}, Sk {Sk}, D {D}, bf16, kv_len {Sk}]: "
          f"{nbytes} B -> {t_bytes:.6f} ms, {ops} flops -> {t_ops:.6f} ms; kernel "
          f"{graphed['kernel']:.6f} ms ({nbytes / graphed['kernel'] / 1e6:.1f} GB/s against "
          f"{HBM_BYTES_PER_S / 1e9:.0f}, {100 * max(t_bytes, t_ops) / graphed['kernel']:.1f}% of "
          f"the bound), plain {graphed['plain']:.6f} ms, sdpa {graphed['sdpa']:.6f} ms, bound "
          f"{max(t_bytes, t_ops):.6f} ms ({bound_by})")
    return dict(name="flash_decode", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_decode.cu",
                replaces="src/repro/kernels/flash_decode.py:78", launches=0,
                max_abs_err=err, ms=graphed["kernel"], plain_ms=graphed["plain"],
                bound_ms=max(t_bytes, t_ops), bound_by=bound_by, library_ms=graphed["sdpa"])


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _margin_clear(logits, tol):
    """[B, G] mask: where the top-1 / top-2 margin exceeds twice ``tol``."""
    top2 = logits.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1] > 2 * tol).T


def _runs_agree(a, b, tol, what):
    """``b`` (teacher-forced on ``a``'s tokens) agrees with ``a``: logits
    within atol = rtol = tol, tokens wherever the margin allows."""
    err = _check_close(b.logits, a.logits, tol, f"{what}: logits")
    clear = _margin_clear(a.logits, tol)
    if not torch.equal(a.tokens[clear], b.tokens[clear]):
        raise AssertionError(f"{what}: greedy tokens differ where the margin exceeds {2 * tol}")
    return err, int(clear.sum()), clear.numel()


def _attn_counts(cfg):
    """(flash_attention launches a prefill, flash_decode launches a decode
    step): one a self- or cross-attention sublayer, one an encoder layer."""
    per = sum(s.kind in ("attn", "xattn") for s in cfg.period) * cfg.n_periods
    return per + cfg.encoder_layers, per


def _serve_batch(cfg, B, S, dev, frames=None, seed=0):
    """Prompts of S positions (a vision model's patch prefix among them,
    as the serving CLI cuts them) and, for an enc-dec model, ``frames``
    frame embeddings; patches and frames drawn in bf16 from ``seed``."""
    batch = serve_batch(cfg, B, S, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    if "patches" in batch:
        batch["patches"] = _randn(g, tuple(batch["patches"].shape), torch.bfloat16, dev)
    if "frames" in batch:
        batch["frames"] = _randn(g, (B, frames or S, cfg.d_model), torch.bfloat16, dev)
    return batch


def _dequantized(cache):
    """A cache tree with int8 entries replaced by the values they stand for."""
    out = {}
    for sub, c in cache.items():
        out[sub] = {k: (kv_dequantize(v, c[f"{k}_scale"]) if v.dtype == torch.int8 else v)
                    for k, v in c.items()}
    return out


def _smoke_card_vs_cpu(cfg, dev, tag):
    """A smoke config on the card against the same run on the CPU (which
    the CPU tests hold to the JAX model), teacher-forced (tokens and MoE
    choices, `Routes`): logits, tokens,
    caches and states within MODEL_TOL, and the kernels launched once an
    attention sublayer (and encoder layer) in prefill and once an attention
    sublayer a decode step."""
    params = M.compute_params(M.init_params(torch.Generator().manual_seed(0), cfg))
    batch = _serve_batch(cfg, SMOKE_BATCH, SMOKE_PROMPT, "cpu", frames=SMOKE_FRAMES)
    routes = Routes()
    cpu = generate(params, cfg, batch, SMOKE_STEPS + 1, routes=routes)
    before = (flash_attention.launches, flash_decode.launches)
    card = generate(_to(params, dev), cfg, _to(batch, dev), SMOKE_STEPS + 1,
                    forced=cpu.tokens.to(dev), routes=routes.replay())
    launched = (flash_attention.launches - before[0], flash_decode.launches - before[1])
    card.logits, card.tokens = card.logits.cpu(), card.tokens.cpu()
    err, clear, n = _runs_agree(cpu, card, MODEL_TOL, f"smoke {cfg.name} card vs CPU")
    # how much of the allowance atol + rtol |logit| the worst logit uses
    used = float(((card.logits - cpu.logits).abs()
                  / (MODEL_TOL * (1 + cpu.logits.abs()))).max())
    want_cache, got_cache = _dequantized(cpu.cache), _dequantized(_to(card.cache, "cpu"))
    cache_err = max(_check_close(got_cache[s][x], want_cache[s][x], MODEL_TOL,
                                 f"smoke {cfg.name} cache {s}/{x}")
                    for s in want_cache for x in want_cache[s])
    prefill_per, step_per = _attn_counts(cfg)
    if launched != (prefill_per, step_per * SMOKE_STEPS):
        raise AssertionError(f"smoke {cfg.name}: kernel launches {launched}, expected "
                             f"{(prefill_per, step_per * SMOKE_STEPS)}")
    print(f"[{tag}] smoke {cfg.name}{' kv_quant' if cfg.kv_quant else ''}: card vs CPU, "
          f"{SMOKE_BATCH} x {SMOKE_PROMPT} prompt positions, {SMOKE_STEPS} teacher-forced steps: "
          f"max |logit diff| {err} ({used:.4f} of the tolerance at the worst logit), caches and "
          f"states {cache_err}, tokens equal at {clear} of {n} clear positions; MoE choices "
          f"replayed, {int(routes.flips)} of {routes.choices} would have gone otherwise; "
          f"launches {launched}")


def _full_width(cfg, batch, gen, tag):
    """One serving run at full width through the kernels, then the same run
    with their plain versions, teacher-forced: fed the first run's tokens,
    and its MoE choices (`Routes`: a near-tie between two experts' gates
    flips with the last bit of the hidden state).  Returns the kernels' launches
    in the first run, which must be one an attention sublayer (and encoder
    layer) in prefill and one an attention sublayer a decode step, without
    an aligning copy; the two runs must agree as closely as bf16 rounding
    allows (`FULL_RMS_TOL`, `FULL_MAX_TOL`, tokens equal where the margin
    exceeds twice the largest difference)."""
    dev = batch["tokens"].device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    master = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    params = M.compute_params(master)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(master))
    print(f"[{tag}] {cfg.name}: {n_params} {cfg.param_dtype} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.3f} s, plus bf16 compute copies; "
          f"{torch.cuda.memory_allocated()} B allocated")
    del master
    B, S = batch["tokens"].shape[0], batch["tokens"].shape[1]
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_attention.copies = 0
    flash_decode.launches = 0
    flash_decode.copies = 0
    routes = Routes()
    run = generate(params, cfg, batch, gen, routes=routes)
    launches = (flash_attention.launches, flash_decode.launches)
    copies = (flash_attention.copies, flash_decode.copies)
    peak = torch.cuda.max_memory_allocated()
    steps = gen - 1
    prefill_per, step_per = _attn_counts(cfg)
    want = (prefill_per, step_per * steps)
    if launches != want:
        raise AssertionError(f"{cfg.name} full width: launches {launches}, expected {want}")
    if copies != (0, 0):
        raise AssertionError(f"{cfg.name} full width: aligning copies {copies}")
    if not bool(torch.isfinite(run.logits).all()):
        raise AssertionError(f"{cfg.name} full width: non-finite logits")
    if run.tokens.shape != (B, gen) or run.tokens.dtype != torch.int32:
        raise AssertionError(f"{cfg.name} full width: tokens {tuple(run.tokens.shape)} "
                             f"{run.tokens.dtype}")
    inputs = ", ".join(f"{k} {list(v.shape)}" for k, v in batch.items())
    print(f"[{tag}] {cfg.name} full width ({cfg.n_layers} layers"
          f"{f' + {cfg.encoder_layers} encoder layers' if cfg.encoder_layers else ''}, d_model "
          f"{cfg.d_model}), {inputs}, {gen} tokens: prefill {run.prefill_s * 1e3:.3f} ms "
          f"({B * S / run.prefill_s:.1f} tok/s), decode {run.decode_s * 1e3 / steps:.4f} ms per "
          f"step ({B * steps / run.decode_s:.1f} tok/s), peak memory {peak} B; launches "
          f"flash_attention {launches[0]}, flash_decode {launches[1]} (copies {copies})")
    print(f"[{tag}] {cfg.name} first generated tokens: {run.tokens[:, :8].tolist()}")
    run.cache = None
    plain = generate(params, cfg, batch, gen, plain=True, forced=run.tokens,
                     routes=routes.replay())
    diff = plain.logits - run.logits
    err = float(diff.abs().max())
    rel_rms = float(diff.pow(2).mean().sqrt() / plain.logits.pow(2).mean().sqrt())
    clear = _margin_clear(plain.logits, err)
    same = bool(torch.equal(run.tokens[clear], plain.tokens[clear]))
    steps_err = diff.abs().amax(dim=(1, 2)).tolist()
    print(f"[{tag}] {cfg.name} full width with the plain versions, teacher-forced: prefill "
          f"{plain.prefill_s * 1e3:.3f} ms, decode {plain.decode_s * 1e3 / steps:.4f} ms per step; "
          f"logit diff: max {err} (first step {steps_err[0]}, last {steps_err[-1]}), rms "
          f"{rel_rms} of the logits' rms (logit std {float(plain.logits.std())}); tokens equal at "
          f"{int(clear.sum())} of {clear.numel()} positions whose margin exceeds {2 * err}: {same}; "
          f"equal overall at {float((run.tokens == plain.tokens).float().mean())}; MoE choices "
          f"replayed: {int(routes.flips)} of {routes.choices} would have gone otherwise")
    if rel_rms > FULL_RMS_TOL or err > FULL_MAX_TOL or not same:
        raise AssertionError(f"{cfg.name} full width: the kernels' run and the plain run disagree "
                             f"(rms {rel_rms} > {FULL_RMS_TOL}, max {err} > {FULL_MAX_TOL}, or "
                             f"tokens differ where the margin exceeds {2 * err})")
    return launches


def phase_dense(dev, rows):
    # (a) smoke size, card against CPU
    for arch in ("qwen3-8b", "h2o-danube-3-4b"):
        _smoke_card_vs_cpu(get_smoke_config(arch), dev, "dense")
    # (b) full width
    cfg = get_config(DENSE_ARCH)
    launches = _full_width(cfg, _serve_batch(cfg, DENSE_BATCH, DENSE_PROMPT, dev), DENSE_GEN,
                           "dense")
    rows["flash_attention"]["launches"], rows["flash_decode"]["launches"] = launches


def phase_zoo(dev, rows):
    """The rest of the model zoo: (a) every other arch's smoke config and
    qwen3-8b's with the int8 KV cache, card against CPU; (b) jamba at its
    published widths, one period of 8 layers; (c) whisper-large-v3 whole."""
    t0 = time.perf_counter()
    for arch in ZOO_ARCHS:
        _smoke_card_vs_cpu(get_smoke_config(arch), dev, "zoo")
    _smoke_card_vs_cpu(dataclasses.replace(get_smoke_config(DENSE_ARCH), kv_quant=True), dev,
                       "zoo")
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=JAMBA_LAYERS)
    launches = _full_width(cfg, _serve_batch(cfg, JAMBA_BATCH, JAMBA_PROMPT, dev), JAMBA_GEN,
                           "zoo")
    for row, n in zip(("flash_attention", "flash_decode"), launches):
        rows[row]["launches"] += n
    torch.cuda.empty_cache()
    cfg = get_config("whisper-large-v3")
    batch = _serve_batch(cfg, WHISPER_BATCH, WHISPER_PROMPT, dev, frames=WHISPER_FRAMES)
    launches = _full_width(cfg, batch, WHISPER_GEN, "zoo")
    for row, n in zip(("flash_attention", "flash_decode"), launches):
        rows[row]["launches"] += n
    print(f"[zoo] phase ran {time.perf_counter() - t0:.1f} s")


def _train_batches(cfg, B, S, steps, dev):
    """``steps`` SyntheticLM batches of B x S tokens on ``dev``, with a
    vision model's patches or an enc-dec model's frames (the trainer CLI's
    shapes, `modality_stubs`) drawn in bf16 from ``default_rng(1)``."""
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    rng = np.random.default_rng(1)
    out = []
    for i in range(steps):
        b = host_batch(ds, i, device=dev)
        for name, (shape, dtype) in modality_stubs(cfg, B, S).items():
            b[name] = torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                                      device=dev).to(dtype)
        out.append(b)
    return out


class TrainRun:
    """What `_train` keeps of a run."""

    def __init__(self):
        self.losses = []       # per step: loss, ce, moe_aux, lr_scale (floats)
        self.grads = {}        # what `keep` made of step 1's gradient
        self.step_s = []       # host clock around each step, synchronised
        self.launches = []     # per step: (flash_attention, flash_attention_bwd) launches
        self.copies = (0, 0)   # aligning copies over the run (forward, backward)


def _f32_on_host(grads) -> dict:
    """Step 1's gradient as f32 copies on the host, by leaf key."""
    return {k: g.detach().float().to("cpu", copy=True) for k, g in tree.paths(grads)}


def _train(cfg, params, opt_name, batches, *, routes=None, plain=False, remat_policy=None,
           keep=_f32_on_host) -> TrainRun:
    """AdamW (or ``opt_name``) steps at the CLI's lr from ``params`` (updated
    in place), one a batch, with the launches of each step counted;
    ``keep`` makes ``run.grads`` of step 1's gradient, after the step."""
    opt = make_optimizer(opt_name, lr=3e-3)
    state = TrainState.create(params, opt.init(params))
    step = build_train_step(cfg, opt, routes=routes, plain=plain, remat_policy=remat_policy)
    dev = batches[0]["tokens"].device
    run = TrainRun()
    copies = (flash_attention.copies, flash_attention_bwd.copies)
    for i, batch in enumerate(batches):
        before = (flash_attention.launches, flash_attention_bwd.launches)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, metrics, grads = step.grads(state.params, batch)
        state, m = step.apply(state, loss, metrics, grads)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        run.step_s.append(time.perf_counter() - t0)
        if i == 0:
            run.grads = keep(grads)
        del grads, loss, metrics
        run.launches.append((flash_attention.launches - before[0],
                             flash_attention_bwd.launches - before[1]))
        run.losses.append({k: float(v) for k, v in m.items()})
    run.copies = (flash_attention.copies - copies[0], flash_attention_bwd.copies - copies[1])
    return run


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _train_smoke_card_vs_cpu(cfg, dev, seq=TRAIN_SMOKE_SEQ):
    """3 steps of a smoke config (``seq`` tokens a sequence) on the card
    against the same steps on the CPU (which the CPU tests hold to the JAX
    package), the CPU run's MoE choices replayed: losses and step-1
    gradients within the CPU tests' tolerances, and flash_attention's
    forward twice (remat) and its backward once an attention sublayer and
    encoder layer a step."""
    opt = cfg.optimizer
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    batches = _train_batches(cfg, TRAIN_SMOKE_BATCH, seq, TRAIN_SMOKE_STEPS, "cpu")
    routes = Routes()
    card_params = tree.map_leaves(lambda t: t.to(dev, copy=True), params)  # before the update
    cpu = _train(cfg, params, opt, batches, routes=routes)
    card = _train(cfg, card_params, opt, [_to(b, dev) for b in batches], routes=routes.replay())
    loss_err = max(abs(c[k] - g[k]) for c, g in zip(cpu.losses, card.losses)
                   for k in ("loss", "ce", "moe_aux"))
    if loss_err > TRAIN_LOSS_TOL:
        raise AssertionError(f"train smoke {cfg.name}: losses differ by {loss_err} > "
                             f"{TRAIN_LOSS_TOL}: {cpu.losses} vs {card.losses}")
    tol = TRAIN_LONG_GRAD_TOL if seq > TRAIN_SMOKE_SEQ else TRAIN_GRAD_TOL.get(cfg.name, 5e-2)
    errs = {k: _rel_l2(card.grads[k], cpu.grads[k]) for k in cpu.grads}
    worst = max(errs, key=errs.get)
    if errs[worst] > tol:
        raise AssertionError(f"train smoke {cfg.name}: step-1 gradient of {worst} differs by "
                             f"{errs[worst]} > {tol} (relative L2)")
    per = _attn_counts(cfg)[0]
    if any(n != (2 * per, per) for n in card.launches):
        raise AssertionError(f"train smoke {cfg.name}: launches per step {card.launches}, "
                             f"expected {(2 * per, per)}")
    print(f"[train] smoke {cfg.name} ({opt}): card vs CPU, {TRAIN_SMOKE_STEPS} steps of "
          f"{TRAIN_SMOKE_BATCH} x {seq} tokens: losses "
          f"{[round(x['loss'], 6) for x in card.losses]}, max |diff| {loss_err}; step-1 "
          f"gradients max relative L2 {errs[worst]} ({worst}); MoE choices replayed, "
          f"{int(routes.flips)} of {routes.choices} would have gone otherwise; launches a step "
          f"(forward, backward) {card.launches[0]}")


def _cli_train(args, *, deterministic=True) -> str:
    """The trainer CLI in a process of its own (deterministic algorithms on,
    with the cuBLAS workspace they need); returns its output."""
    code = ("import sys, torch\n"
            f"torch.use_deterministic_algorithms({deterministic})\n"
            "from repro_torch.launch.train import main\n"
            "main(sys.argv[1:])\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    out = subprocess.run([sys.executable, "-c", code, *args], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"trainer CLI {args} failed:\n{out.stdout}\n{out.stderr}")
    return out.stdout


def _manifest(path) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return {k: v["sha1"] for k, v in json.load(f)["arrays"].items()}


def _train_resume(dev):
    """The CLI on the card: 6 smoke steps straight with checkpoints every 3,
    then from the step-3 checkpoint alone with --resume, both under
    deterministic algorithms: the two final checkpoints must be equal, SHA1
    for SHA1.  Two straight runs without deterministic algorithms show
    whether the path needs them: whether they end in one checkpoint, and in
    the deterministic runs' (torch's deterministic forms may sum in another
    order)."""
    import shutil
    import tempfile

    common = ["--arch", "qwen3-8b", "--smoke", "--device", dev.type, "--steps", "6",
              "--ckpt-every", "3", "--log-every", "3"]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        straight, resumed, free, free2 = (os.path.join(tmp, n) for n in (
            "straight", "resumed", "free", "free2"))
        _cli_train(common + ["--ckpt-dir", straight])
        shutil.copytree(os.path.join(straight, "step_00000003"),
                        os.path.join(resumed, "step_00000003"))
        with open(os.path.join(resumed, "LATEST"), "w") as f:
            f.write("3")
        log = _cli_train(common + ["--ckpt-dir", resumed, "--resume"])
        if "resumed from step 3" not in log:
            raise AssertionError(f"the trainer CLI did not resume:\n{log}")
        want = _manifest(os.path.join(straight, "step_00000006"))
        got = _manifest(os.path.join(resumed, "step_00000006"))
        if got != want:
            bad = sorted(k for k in want if got.get(k) != want[k])
            raise AssertionError(f"resumed run differs from the straight run in {bad[:8]}")
        free_sums = []
        for path in (free, free2):
            _cli_train(common + ["--ckpt-dir", path], deterministic=False)
            free_sums.append(_manifest(os.path.join(path, "step_00000006")))
    differ = sorted(k for k in want if free_sums[0][k] != free_sums[1][k])
    print(f"[train] resume: the CLI's 6 smoke steps on {dev.type} and a run resumed from step 3, "
          f"under deterministic algorithms, end in the same checkpoint, {len(want)} arrays SHA1 "
          f"for SHA1; two runs without deterministic algorithms "
          f"{'end in one checkpoint' if not differ else f'differ in {len(differ)} arrays'} "
          f"{differ[:6]}, "
          f"{'equal to' if free_sums[0] == want else 'other than'} the deterministic runs'")


def f64_attention(q, k, v, *, causal=True, window=None, scale=None, q_offset=0):
    """The quadratic form in float64 (causal, no window), cast to q's type;
    differentiable.  The noise floor's attention (scripts/dense_noise_floor.py)."""
    if window is not None or scale is not None or q_offset or not causal:
        raise ValueError("the float64 attention covers causal attention with no window only")
    group = q.shape[1] // k.shape[1]
    S = q.shape[2]
    qd = q.double() / math.sqrt(q.shape[-1])
    kd = k.double().repeat_interleave(group, dim=1)
    vd = v.double().repeat_interleave(group, dim=1)
    future = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax((qd @ kd.transpose(-1, -2)).masked_fill(future, float("-inf")), dim=-1)
    return (probs @ vd).to(q.dtype)


def train_cell(dev):
    """The full-width training cell's config and batches."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    return cfg, _train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, dev)


def train_full(cfg, batches, *, attention=None, plain=False, **kw) -> TrainRun:
    """A training cell's steps from weights drawn on the card from seed 0
    in the config's dtype, with its optimizer; ``attention`` replaces the
    plain attention of a ``plain`` run (the noise floor's float64 form);
    ``kw`` go to `_train`."""
    dev = batches[0]["tokens"].device
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    kept = layers.flash_attention_plain
    if attention is not None:
        layers.flash_attention_plain = attention
    try:
        return _train(cfg, params, cfg.optimizer, batches, plain=plain, **kw)
    finally:
        layers.flash_attention_plain = kept


def train_floor(kernels: TrainRun, plain: TrainRun, f64: TrainRun):
    """Per step, the loss differences (kernels vs plain, plain vs float64),
    and per leaf the step-1 gradients' relative L2 differences."""
    loss = [(abs(a["loss"] - b["loss"]), abs(b["loss"] - c["loss"]))
            for a, b, c in zip(kernels.losses, plain.losses, f64.losses)]
    grads = {k: (_rel_l2(kernels.grads[k], plain.grads[k]), _rel_l2(plain.grads[k], f64.grads[k]))
             for k in plain.grads}
    return loss, grads


def _train_full_width(dev):
    """The training cell through the kernels, then with the plain attention
    and with the plain attention in float64 (the floor); returns the
    kernels' launches over the run."""
    cfg, batches = train_cell(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention_bwd.launches = 0
    flash_attention.copies = flash_attention_bwd.copies = 0
    kernels = train_full(cfg, batches)
    launches = (flash_attention.launches, flash_attention_bwd.launches)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(g.numel() for g in kernels.grads.values())
    if any(n != (2 * TRAIN_LAYERS, TRAIN_LAYERS) for n in kernels.launches):
        raise AssertionError(f"training cell: launches per step {kernels.launches}, expected "
                             f"{(2 * TRAIN_LAYERS, TRAIN_LAYERS)}")
    if kernels.copies != (0, 0):
        raise AssertionError(f"training cell: aligning copies {kernels.copies}")
    if not all(math.isfinite(x["loss"]) for x in kernels.losses):
        raise AssertionError(f"training cell: losses {kernels.losses}")
    step_s = sum(kernels.step_s[1:]) / (TRAIN_STEPS - 1)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[train] {cfg.name} at full width (d_model {cfg.d_model}, vocab {cfg.vocab_size}), "
          f"{TRAIN_LAYERS} of 36 layers, {n_params} f32 parameters, AdamW, batches of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: {step_s * 1e3:.3f} ms a step over steps 2-"
          f"{TRAIN_STEPS} ({tokens / step_s:.1f} tokens/s; step 1 {kernels.step_s[0] * 1e3:.3f} "
          f"ms), peak memory {peak} B; flash_attention launches a step (forward, backward) "
          f"{kernels.launches[0]}, aligning copies {kernels.copies}; losses "
          f"{[x['loss'] for x in kernels.losses]}, lr scales "
          f"{[x['lr_scale'] for x in kernels.losses]}")
    plain = train_full(cfg, batches, plain=True)
    plain_ms = sum(plain.step_s[1:]) * 1e3 / (TRAIN_STEPS - 1)
    print(f"[train] the same steps with the plain attention: {plain_ms:.3f} ms a step; losses "
          f"{[x['loss'] for x in plain.losses]}")
    f64 = train_full(cfg, batches, plain=True, attention=f64_attention)
    loss, grads = train_floor(kernels, plain, f64)
    _check_floor(f"{cfg.name} training cell", loss, grads, kernels.losses[0]["loss"])
    return launches


def _check_floor(what, loss, grads, loss0):
    """Print the floor (the plain attention in f32 against float64) and the
    kernels' distance from the plain run, per step's loss and per leaf of
    the step-1 gradient (`train_floor`'s pairs), and fail where the kernels
    stand more than `TRAIN_FLOOR_RATIO` times the floor away."""
    eps = float(np.finfo(np.float32).eps)
    loss_ratio = max(a for a, _ in loss) / max(max(b for _, b in loss), eps * loss0)
    ratios = {k: a / max(b, eps) for k, (a, b) in grads.items()}
    worst = max(ratios, key=ratios.get)
    print(f"[train] {what}: floor (the plain attention in f32 against float64): losses differ "
          f"by {[b for _, b in loss]}, step-1 gradients by relative L2 up to "
          f"{max(b for _, b in grads.values())} (median "
          f"{float(np.median([b for _, b in grads.values()]))}); the kernels against the plain "
          f"attention: losses {[a for a, _ in loss]}, gradients up to "
          f"{max(a for a, _ in grads.values())}; ratio to the floor: losses {loss_ratio}, "
          f"gradients {ratios[worst]} ({worst}), limit {TRAIN_FLOOR_RATIO}")
    if loss_ratio > TRAIN_FLOOR_RATIO or ratios[worst] > TRAIN_FLOOR_RATIO:
        raise AssertionError(f"{what}: the kernels' run stands "
                             f"{max(loss_ratio, ratios[worst])} times the floor from the plain "
                             f"run (limit {TRAIN_FLOOR_RATIO})")


def _mean_ms(run: TrainRun) -> float:
    """ms a step over the timed steps: all but the first, or a lone first."""
    timed = run.step_s[1:] or run.step_s
    return sum(timed) * 1e3 / len(timed)


@contextlib.contextmanager
def unchunked_scans():
    """The recurrent blocks' training forms replaced by their prefill forms'
    outputs, whose backward keeps every step's state (the scans without
    `ssm.chunked_scan`'s checkpoints); restored on exit."""
    kept = {k: getattr(ssm, k) for k in ("mamba", "mlstm", "slstm")}
    for k in kept:
        setattr(ssm, k, lambda p, cfg, x, f=getattr(ssm, f"{k}_prefill"): f(p, cfg, x)[0])
    try:
        yield
    finally:
        for k, fn in kept.items():
            setattr(ssm, k, fn)


def _train_xlstm(dev):
    """(d) xlstm-350m whole at its published widths and batch, 256 tokens:
    the chunked scans (ms a step, tokens/s, peak memory) and the unchunked
    ones, bit-equal, with their two peaks."""
    cfg = get_config(XLSTM_ARCH)
    B, S = XLSTM_BATCH, XLSTM_CMP_SEQ
    batches = _train_batches(cfg, B, S, XLSTM_CMP_STEPS, dev)
    runs, peaks = {}, {}
    flash_attention.launches = flash_attention_bwd.launches = 0
    for form in ("chunked", "unchunked"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with unchunked_scans() if form == "unchunked" else contextlib.nullcontext():
            runs[form] = train_full(cfg, batches)
        peaks[form] = torch.cuda.max_memory_allocated()
    a, b = runs["chunked"], runs["unchunked"]
    if any(n != (0, 0) for n in a.launches + b.launches):
        raise AssertionError(f"{cfg.name}: attention launches {a.launches} (it has none)")
    if not all(math.isfinite(x["loss"]) for x in a.losses):
        raise AssertionError(f"{cfg.name} training: losses {a.losses}")
    dh = int(cfg.xlstm_proj_factor * cfg.d_model) // cfg.n_heads
    # each unchunked step saves the incoming C and k v^T, [B, H, dh, dh] f32 each
    states = 2 * B * cfg.n_heads * dh * dh * 4
    differ = sorted(k for k in a.grads if not torch.equal(a.grads[k], b.grads[k]))
    ms = _mean_ms(a)
    print(f"[train] (d) {cfg.name} whole ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, vocab {cfg.vocab_size}), "
          f"{sum(g.numel() for g in a.grads.values())} f32 parameters, AdamW, batches of {B} x "
          f"{S} tokens, {XLSTM_CMP_STEPS} step(s): chunked scans {ms:.3f} ms a step "
          f"({B * S / ms * 1e3:.1f} tokens/s), peak memory {peaks['chunked']} B; unchunked "
          f"{_mean_ms(b):.3f} ms a step, peak memory {peaks['unchunked']} B (reckoned: "
          f"{states * S} B of saved states a mLSTM sublayer, {states * XLSTM_SEQ} B at "
          f"{XLSTM_SEQ} tokens); losses {[x['loss'] for x in a.losses]} and "
          f"{[x['loss'] for x in b.losses]}; step-1 gradients differ in {len(differ)} of "
          f"{len(a.grads)} leaves")
    if a.losses != b.losses or differ:
        raise AssertionError(f"{cfg.name}: the chunked and unchunked scans differ (losses "
                             f"{a.losses} vs {b.losses}; gradients {differ[:6]})")


class _HostGrads:
    """One run's step-1 gradient on the host in its own dtype, which the
    next runs' are held to leaf by leaf on the card (jamba's 27 GB fit the
    host once, not once a run, in f32)."""

    def __init__(self):
        self.leaves = {}

    def keep(self, grads) -> dict:
        self.leaves = {k: g.to("cpu", copy=True) for k, g in tree.paths(grads)}
        return {}

    def equal(self, grads) -> dict:
        """Per leaf: bit-equal to the kept one."""
        return {k: bool(torch.equal(g, self.leaves[k].to(g.device)))
                for k, g in tree.paths(grads)}

    def rel_l2(self, grads, replace: bool = False) -> dict:
        """Per leaf: the relative L2 distance from the kept one (in f32, a
        slice at a time); with ``replace`` this run's leaves are kept."""
        out = {}
        for k, g in tree.paths(grads):
            ref = self.leaves[k].to(g.device).reshape(-1)
            num = den = 0.0
            for s0 in range(0, ref.numel(), 1 << 26):
                x, y = g.reshape(-1)[s0:s0 + (1 << 26)].float(), ref[s0:s0 + (1 << 26)].float()
                num += float((x - y).square().sum(dtype=torch.float64))
                den += float(y.square().sum(dtype=torch.float64))
            out[k] = math.sqrt(num) / max(math.sqrt(den), 1e-30)
            if replace:
                self.leaves[k] = g.to("cpu", copy=True)
        return out


def _train_jamba(dev):
    """(e) jamba's period at its published widths with bf16 weights and
    Adafactor: the kernels' run (ms a step, tokens/s, peak memory,
    launches), the same steps with
    ``remat_policy="save_ffn"`` (bit-equal), with the plain attention and
    with the plain attention in float64 (the floor), the MoE choices of the
    first run replayed.  Returns the kernels' launches of the first two."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=JAMBA_LAYERS)
    B, S, steps = JAMBA_TRAIN_BATCH, JAMBA_TRAIN_SEQ, JAMBA_TRAIN_STEPS
    batches = _train_batches(cfg, B, S, steps, dev)
    host, routes = _HostGrads(), Routes()
    per = (2 * _attn_counts(cfg)[0], _attn_counts(cfg)[0])

    def run(**kw):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r = train_full(cfg, batches, **kw)
        r.peak = torch.cuda.max_memory_allocated()
        return r

    flash_attention.launches = flash_attention_bwd.launches = 0
    flash_attention.copies = flash_attention_bwd.copies = 0
    kernels = run(keep=host.keep, routes=routes)
    if any(n != per for n in kernels.launches) or kernels.copies != (0, 0):
        raise AssertionError(f"{cfg.name} training: launches per step {kernels.launches}, "
                             f"expected {per}; copies {kernels.copies}")
    if not all(math.isfinite(x["loss"]) for x in kernels.losses):
        raise AssertionError(f"{cfg.name} training: losses {kernels.losses}")
    ms = _mean_ms(kernels)
    print(f"[train] (e) {cfg.name} at its published widths, {cfg.n_layers} of 32 layers "
          f"(d_model {cfg.d_model}, {cfg.moe_experts} experts, vocab {cfg.vocab_size}), "
          f"{cfg.param_dtype}, {cfg.optimizer}, batches of {B} x {S} tokens, {steps} steps: "
          f"{ms:.3f} ms a step after the first ({B * S / ms * 1e3:.1f} tokens/s; step 1 "
          f"{kernels.step_s[0] * 1e3:.3f} ms), peak memory {kernels.peak} B; launches a step "
          f"(forward, backward) {kernels.launches[0]}, aligning copies {kernels.copies}; losses "
          f"{[x['loss'] for x in kernels.losses]}")
    save = run(keep=host.equal, routes=routes.replay(), remat_policy="save_ffn")
    differ = sorted(k for k, same in save.grads.items() if not same)
    print(f"[train] (e) {cfg.name} with remat_policy='save_ffn': {_mean_ms(save):.3f} ms a step "
          f"(none: {ms:.3f}), peak memory {save.peak} B (none: {kernels.peak}); losses "
          f"{'equal' if save.losses == kernels.losses else 'differ'}, step-1 gradients differ in "
          f"{len(differ)} of {len(save.grads)} leaves; launches a step {save.launches[0]}")
    if save.losses != kernels.losses or differ or any(n != per for n in save.launches):
        raise AssertionError(f"{cfg.name}: the save_ffn run differs from the first (losses "
                             f"{save.losses} vs {kernels.losses}; gradients {differ[:6]}; "
                             f"launches {save.launches})")
    launches = (flash_attention.launches, flash_attention_bwd.launches)
    plain = run(keep=lambda g: host.rel_l2(g, replace=True), routes=routes.replay(),
                plain=True)
    print(f"[train] (e) {cfg.name} with the plain attention: {_mean_ms(plain):.3f} ms a step, "
          f"peak memory {plain.peak} B; MoE choices replayed, {int(routes.flips)} of "
          f"{routes.choices} would have gone otherwise")
    f64 = run(keep=host.rel_l2, routes=routes.replay(), plain=True, attention=f64_attention)
    loss = [(abs(a["loss"] - b["loss"]), abs(b["loss"] - c["loss"]))
            for a, b, c in zip(kernels.losses, plain.losses, f64.losses)]
    grads = {k: (plain.grads[k], f64.grads[k]) for k in plain.grads}
    _check_floor(f"{cfg.name} training cell", loss, grads, kernels.losses[0]["loss"])
    return launches


def phase_train(dev, rows):
    """Training: (a) every arch's smoke config on the card against the
    CPU (the recurrent ones at 256 tokens too), (b) the trainer CLI's
    resume, bit for bit, (c) the full-width dense cell against its plain
    run within the float64 floor, (d) xlstm-350m whole, (e) jamba's period
    at its published widths."""
    t0 = time.perf_counter()
    for arch in ARCH_IDS:
        _train_smoke_card_vs_cpu(get_smoke_config(arch), dev)
    for arch in TRAIN_SMOKE_LONG_ARCHS:
        _train_smoke_card_vs_cpu(get_smoke_config(arch), dev, seq=TRAIN_SMOKE_LONG_SEQ)
    _train_resume(dev)
    launches = _train_full_width(dev)
    rows["flash_attention"]["launches"] += launches[0]
    rows["flash_attention_bwd"]["launches"] = launches[1]
    t1 = time.perf_counter()
    _train_xlstm(dev)
    t2 = time.perf_counter()
    launches = _train_jamba(dev)
    rows["flash_attention"]["launches"] += launches[0]
    rows["flash_attention_bwd"]["launches"] += launches[1]
    print(f"[train] phase ran {time.perf_counter() - t0:.1f} s: (d) {t2 - t1:.1f} s, (e) "
          f"{time.perf_counter() - t2:.1f} s")


def _example(name: str):
    """``examples/torch_<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                  os.path.join(ROOT, "examples",
                                                               f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_KERNELS = {"spray_select": spray_select, "lt_encode": lt_encode, "link_fold": link_fold,
            "flash_attention": flash_attention, "flash_decode": flash_decode,
            "flash_attention_bwd": flash_attention_bwd}


def _zero_launches():
    for kernel in _KERNELS.values():
        kernel.launches = 0


def _launches() -> dict:
    return {name: kernel.launches for name, kernel in _KERNELS.items()}


def _quiet(fn, *args, **kw):
    """``fn``'s result, its printout kept from the log."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def phase_examples(dev, rows):
    """Every example at its CPU tests' sizes (its module's SMOKE), on the card
    (the kernels' launches counted into ``rows``) and then on the CPU: the
    network examples' returned numbers equal (and the telemetry exports'
    bytes); serving teacher-forced within MODEL_TOL of the CPU's logits, on
    the same weights drawn on the CPU; training's losses within
    TRAIN_LOSS_TOL of the CPU's, from the same weights (the bodies of those
    two examples' ``main``, which draws its weights on its device)."""
    t0 = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "examples")
    shutil.rmtree(out_dir, ignore_errors=True)
    times = {}
    for name in EXAMPLES_NET:
        ex = _example(name)
        runs = {}
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            kw = dict(ex.SMOKE)
            if name == "telemetry_quickstart":
                kw["out_dir"] = os.path.join(out_dir, "telemetry", where)
            _zero_launches()
            t1 = time.perf_counter()
            runs[where] = _quiet(ex.main, ["--device", str(device)], **kw)
            times[where] = time.perf_counter() - t1
            if where == "card":
                launched = {k: n for k, n in _launches().items() if n}
                for k, n in launched.items():
                    rows[k]["launches"] += n
        if runs["card"] != runs["cpu"]:
            raise AssertionError(f"example {name}: the card's numbers differ from the CPU's: "
                                 f"{runs['card']} vs {runs['cpu']}")
        if name == "telemetry_quickstart":
            for f in sorted(os.listdir(os.path.join(out_dir, "telemetry", "cpu"))):
                a, b = (open(os.path.join(out_dir, "telemetry", w, f), "rb").read()
                        for w in ("card", "cpu"))
                if a != b:
                    raise AssertionError(f"example {name}: {f} differs, card against CPU")
        # every example sprays with WAM; all but these two run the shared fabric
        needed = ["spray_select"] + ([] if name in ("quickstart", "collective_cct_demo")
                                     else ["link_fold"])
        if not all(launched.get(k) for k in needed):
            raise AssertionError(f"example {name}: launches on the card {launched}, "
                                 f"needs {needed}")
        print(f"[examples] {name} ({ex.SMOKE}): card = CPU on every returned number; "
              f"launches on the card {launched}; {times['card']:.2f} s on the card, "
              f"{times['cpu']:.2f} s on the CPU")

    ex = _example("serve_batched")
    cfg = get_smoke_config("qwen3-8b")
    params = M.compute_params(M.init_params(torch.Generator().manual_seed(0), cfg))
    cpu = _quiet(ex.serve, params, cfg, **ex.SMOKE, device=torch.device("cpu"))
    _zero_launches()
    card = _quiet(ex.serve, _to(params, dev), cfg, **ex.SMOKE, device=dev,
                  forced=torch.as_tensor(cpu["tokens"]).to(dev))
    launched = _launches()
    for k, n in launched.items():
        rows[k]["launches"] += n
    per = _attn_counts(cfg)[0]
    if (launched["flash_attention"], launched["flash_decode"]) != (
            per, per * (ex.SMOKE["gen"] - 1)):
        raise AssertionError(f"example serve_batched: launches {launched}")
    got, want = torch.as_tensor(card["logits"]), torch.as_tensor(cpu["logits"])
    err = _check_close(got, want, MODEL_TOL, "example serve_batched: logits, card vs CPU")
    clear = _margin_clear(want, MODEL_TOL)
    if not np.array_equal(card["tokens"][clear.numpy()], cpu["tokens"][clear.numpy()]):
        raise AssertionError("example serve_batched: tokens differ where the margin is clear")
    print(f"[examples] serve_batched ({cfg.name} smoke, {ex.SMOKE}): card teacher-forced on "
          f"the CPU's tokens, max |logit diff| {err}, tokens equal at {int(clear.sum())} of "
          f"{clear.numel()} clear positions; launches (flash_attention, flash_decode) "
          f"({launched['flash_attention']}, {launched['flash_decode']})")

    ex = _example("train_tiny_lm")
    cfg = ex.tiny_config("smoke", ex.SMOKE_SIZES)
    steps, seq, batch = (int(ex.SMOKE_ARGV[ex.SMOKE_ARGV.index(f) + 1])
                         for f in ("--steps", "--seq-len", "--batch"))
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    card_params = tree.map_leaves(lambda t: t.to(dev, copy=True), params)
    run = dict(steps=steps, seq_len=seq, batch=batch, log_every=1, ckpt_every=2)
    cpu = _quiet(ex.train, params, cfg, ckpt_dir=os.path.join(out_dir, "train_cpu"), **run)
    _zero_launches()
    card = _quiet(ex.train, card_params, cfg, ckpt_dir=os.path.join(out_dir, "train_card"),
                  **run)
    launched = _launches()
    for k, n in launched.items():
        rows[k]["launches"] += n
    if (launched["flash_attention"], launched["flash_attention_bwd"]) != (
            2 * cfg.n_layers * steps, cfg.n_layers * steps):
        raise AssertionError(f"example train_tiny_lm: launches {launched}")
    err = max(abs(card["losses"][k] - cpu["losses"][k]) for k in cpu["losses"])
    if card["losses"].keys() != cpu["losses"].keys() or err > TRAIN_LOSS_TOL:
        raise AssertionError(f"example train_tiny_lm: losses {card['losses']} vs "
                             f"{cpu['losses']}")
    print(f"[examples] train_tiny_lm (smoke, {steps} steps of {batch} x {seq}): losses "
          f"{card['losses']}, max |diff| against the CPU {err}; launches (flash_attention, "
          f"flash_attention_bwd) ({launched['flash_attention']}, "
          f"{launched['flash_attention_bwd']})")

    print(f"[examples] phase ran {time.perf_counter() - t0:.1f} s")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    print(f"[card] {card}")
    t0 = t_start = time.time()
    logs = build.build_all()
    for name, log in logs.items():
        print(f"[build] {name}: {log.strip()}")
    for name in ("spray_select", "lt_encode", "link_fold", "flash_attention",
                 "flash_attention_bwd", "flash_attention_bwd_f32"):
        report = ptxas_report(logs[name])
        if logs[name] == "up to date":
            print(f"[build] ptxas {name}: built by an earlier run, no report")
        elif not report:
            raise AssertionError(f"no ptxas report for {name}.cu in the build log")
        for kernel, regs, stores, loads in report:
            print(f"[build] ptxas {name}: {kernel}: {regs} registers, spill stores {stores} B, "
                  f"spill loads {loads} B")
            if name.startswith("flash_attention") and (stores or loads):
                raise AssertionError(f"ptxas spills in {name}.cu: {kernel}")
    print(f"[build] {len(logs)} kernel(s) built in {time.time() - t0:.1f} s")
    message = coded_message()
    rows = {"spray_select": phase_kernels(dev), "lt_encode": phase_lt_encode(dev, message),
            "flash_attention": phase_flash_attention(dev),
            "flash_attention_bwd": phase_flash_attention_bwd(dev),
            "flash_decode": phase_flash_decode(dev), "link_fold": phase_link_fold(dev)}
    phase_goldens(dev)
    phase_wide(dev, rows)
    family_result = phase_fat_tree(dev, rows)
    phase_jobs(dev, rows)
    phase_shard(dev, rows, family_result)
    phase_coded(dev, rows, message)
    phase_router(dev, rows)
    phase_dense(dev, rows)
    torch.cuda.empty_cache()
    phase_zoo(dev, rows)
    torch.cuda.empty_cache()
    phase_train(dev, rows)
    phase_examples(dev, rows)
    for row in rows.values():
        if not all(math.isfinite(row[k]) for k in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"non-finite timing in {row}")
    print(f"[total] chip_smoke.py ran {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
