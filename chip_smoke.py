#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):

1. device  — the card's name, count, and ``nvidia-smi`` name + power limit;
   no card is a failure.
2. build   — the CUDA kernels are built from ``src/repro_torch/csrc``
   (seconds, and ``ptxas -v`` register / shared-memory / spill lines).
3. kernels — each kernel against its plain PyTorch version at the shapes the
   main path gives it, with the tolerance stated, and timed with CUDA events
   and ``torch.profiler`` (device time per call: the drain kernel's split and
   merge launches summed; a profiled window that lost a record is profiled
   again) beside its bound, its plain version and, where one exists, one
   PyTorch call that computes the same function.  The paged decode kernel
   (its keys split across blocks, one launch a call), ssd_chunk and hi_gate
   (each row split across blocks, merged in the same launch) are also
   timed by CUDA events around one replay of a CUDA graph of 100 calls,
   with no host submission in the window.  hi_gate is timed at every shape
   the path gives it (``GATE_SHAPES``), with ``torch.softmax(x, -1).max(-1)``
   beside it (two calls: no single call computes the gate), and checked
   with a max duplicated across splits and one in the last split;
   copy_pages also reports the wrapper's host time per call.  The chunk kernel's bound is that of its path, three bf16
   tensor-core passes per float32 product, and ssd_chunk's three TF32
   passes, each with the float32-FMA bound beside it.  ssd_chunk at
   mamba2-370m's L and S admission shapes and zamba2-2.7b's L shape, with
   its padded-tail exactness; the paged decode kernel also at zamba2's head
   dim 80 with NaN and inf planted where no query may look.  The int8
   bodies of the paged decode kernel (qwen2's L shape at head dim 128,
   zamba2's at 80) and of the chunk kernel (C = 256), each with NaN / inf
   scales and arbitrary bytes planted where no query may look (the output
   must not move), and copy_pages over int8 pools with their scale rows at
   K = 2 (8-byte rows) and K = 32, byte-equal to the plain version.  The
   chunk kernel also at the speculative verify lane's shape, q (8, 4, 12,
   128) over the 8-slot L pool, bf16 and int8 with garbage planted, with a
   CUDA-graph replay (nested as ``verify`` in its entries of the kernels
   line); hi_gate also at the classifier cascade's (2,000, 10), timed in
   max_prob and entropy (nested as ``cascade`` in its entry).
   cascade — the paper's Figure-1 pipeline over classifiers:
   ``HICascade`` over random SML_CIFAR / LML_CIFAR at their published
   widths, 10,000 images of ``data/images`` in batches of 2,000, theta at
   the S tier's median confidence: hi_gate launched once a batch and equal
   to the plain metric (masks, served sets, drops; predictions where the S
   margin is decisive), the dog filter's one-logit head on the sigmoid
   with no launch, and the paper's Table 1 / Table 3 / Fig. 8 numbers
   through the port's replay.
4. serve   — the drain path: ``HIEngine.serve`` on the full-width qwen2-1.5b
   cascade (L = qwen2-1.5b, S = its ``s_variant(4)``), random float32 params
   from a seeded ``torch.Generator``, bf16 KV cache; 16 requests through
   ``Batcher(8, buckets=(128, 512))``, then the last batch again with theta
   at its median confidence, so that both branches of the offload rule run.
   Asserts one host fetch per serve and the kernels' launch counts, checks
   the outputs, and holds the port on the card against the port on the CPU
   on a small input, teacher-forced.
5. stream  — the continuous path: ``HIEngine.serve_stream`` on the same
   full-width cascade over the paged KV pools (prefix sharing, chunked
   prefill), one trace of 32 requests that mixes ``mixed_poisson``-,
   ``repeated_prefix``- and ``long_prompt``-style prompts, served at theta
   0.6 and again at the median S confidence.  Asserts one host fetch per
   tick, every kernel's launches against what the host's lane flags
   predict, copy-on-write copies, saved prefill tokens and chunk ticks, one
   record per request, the pools' invariants every tick and no held slot
   after drain; and holds the stream on the card against the CPU on a
   small input, and a fixed run of the paged API over an int8 pool
   (prefill, COW, decode, a chunk) on the card against the CPU: logits
   within a limit below the int8-vs-bf16 gap, levels within 1, scales.
6. trace   — one more drain serve, and one ``serve_stream`` tick window,
   under ``torch.profiler``: the device's time by kernel kind (the chunk
   kernel apart from the paged decode kernel) and its busy
   share of the wall time (``--trace DIR`` keeps the gzipped Chrome traces
   in DIR).  Then the stream phase again with ``kv_dtype="int8"``: the int8
   kernels' launches against the lane flags, pool bytes at most 0.55x the
   bf16 run's, the slots the bf16 byte budget admits in int8, the free-run
   token agreement with the bf16 run, the L tier's decode step time over
   bf16 and int8 pools, and the reference's teacher-forced measure on the
   L tier (reported).  Then, each run on a fresh scheduler:
   faults — the stream trace under a seeded ``FaultSchedule`` (20% of
   escalation transits lost, an L outage that opens the breaker, a latency
   spike) with a ``RetryPolicy`` and ``validate=True``, twice: one status
   of ``STATUSES`` per request, ``ok`` and ``degraded_local`` both, the
   breaker opened and closed again, no slot held, one fetch per tick,
   launches against the lane flags, and the two runs' records equal field
   by field; a pure delay gives the fault-free tokens.
   observability — the trace with ``Telemetry``, ``GateAudit``,
   ``SLOWatchdog`` and ``FlightRecorder`` on and with them off: the same
   tokens and confidences, one fetch per tick, one scheduler build; TTFT /
   TPOT quantiles, the audit's decision counts and the host ms per tick on
   and off (``--trace DIR`` also writes and parses back the Chrome trace).
   speculative — ``serve_stream(speculative=True)``, 8 slots paired 1:1,
   ``decode_block`` 4, sharing and the chunk lane on: at theta 0 the plain
   stream's S tokens; at theta 0.6 the port's host oracle
   (``TokenCascade.generate_speculative`` on the card) on the positions it
   chose by a margin over ``SPEC_MARGIN_TOL``; the chunk kernel launched
   once per L layer and verify tick besides the chunk lanes; drafted,
   accepted, acceptance rate and req/s.
   legacy — ``serve_legacy`` (per-token prefill and greedy decode, the
   route on the host) on one batch of 8 prompts of 128: the drain kernel
   launched (128 + 16) x (7 + 28) times and no hi_gate, the offloads and
   mean confidences of ``serve`` on the same batch, tokens up to a
   teacher-forced margin, and both req/s.
   temperature — the sampler's keys and bits on the card against the
   CPU's, bit for bit, and the committed words generated with jax; one
   sampling step's time at (8, 151,936); the stream trace at temperature
   0.7, theta 0: ``serve`` by bucket and ``serve_stream`` twice, the two
   stream runs equal and equal to the drain on decisive draws.
   mesh — the stream trace's first 16 requests at their median S
   confidence through ``serve_stream(mesh=make_serving_mesh(1, 1))``, a
   world-size-1 NCCL group (one H100 holds one rank), and with
   ``mesh=None`` on the same engine, over bf16 and int8 pools with sharing
   and the chunk lane on: tokens, statuses and offloads bitwise, one host
   fetch per tick, the launches the lane flags predict, every pool's
   invariants after the run, req/s with and without the mesh.  The MoE
   phase also holds ``moe_ffn_sharded`` on that mesh against ``moe_ffn``
   bit for bit, with the same dropped pairs, at the full-width layer's
   decode and admission inputs, and the training phase one reduced
   qwen2-1.5b train step on the mesh against the unmeshed step.
7. mamba2  — the SSM family at full size (L mamba2-370m, 48 layers; S 12):
   phases 4 to 6 again (drain with ssd_chunk launched once per layer per
   prefill; the 32-request stream trace at vocab 50,280 with the chunk lane
   off, asserting whole-prompt restores and saved prefill tokens; its
   trace), each with its small card-against-CPU check.
8. chunk   — the chunk lane at mamba2 widths cut to 8 layers (S 2): four
   prompts of 96..200 tokens fed 64 per tick, the staged rollback on the
   card, tokens against the same per-token steps on a one-row cache.  Then
   the speculative lane at the same widths and depth: theta 0 against the
   plain stream, theta 0.6 against the host oracle, and the recurrent state
   the rollback copies a tick.
9. hybrid  — zamba2-2.7b at full width cut to 24 layers (S 6; the
   reference cannot build the full-depth cascade): a 12-request stream
   with repeated system prompts, asserting ssd_chunk, the paged kernel at
   head dim 80, copy_pages and hi_gate against the lane flags (the small
   card-against-CPU checks first, the int8 paged run among them); then the
   same with int8 pools (the byte ratio reported: the recurrent state does
   not shrink).
10. gate   — the reference's int8 fidelity gate on the card with the
   kernels: reduced zamba2-2.7b, 8 slots, 16 teacher-forced steps, bf16
   against int8 pools, >= 0.99 of the 136 greedy decisions agree.
11. moe     — run right after phase 3's cascade, on a card that holds
   nothing else yet and before any traced phase (the kernel checks below
   run with phase 3's).  Kernels 1-5 against their
   plain versions at the MoE family's shapes (deepseek-moe-16b: group 1 at
   head dim 128, 16 kv heads in the L tier and 4 in the S tier, vocab
   102,400, the verify lane's q (8, 4, 16, 128); int8 bodies with garbage
   planted) and at llava-next-34b's group of 7 (q (4, 1, 56, 128) over 8
   kv heads, and its chunk lane), nested as ``moe`` in each kernel's
   entry.  Reduced deepseek-moe-16b and arctic-480b on the card against
   the CPU (prefill and teacher-forced decode: logits held over float32
   caches, decisive tokens over bf16; the int8 paged trace; deepseek's
   small stream), and reduced granite-3-2b, h2o-danube-3-4b, llava (with
   its patch prefix) and whisper-large-v3 (forward, then its cross K/V and
   decode).  Then deepseek-moe-16b at its published widths and depth (L 28
   layers, S 7), random float32 params: phase 4's drain, the stream trace's
   first 16 requests through ``serve_stream`` at theta 0.6 and the median,
   the same over int8 pools, and the speculative lane, each asserting one
   host fetch per tick and the launches the lane flags predict (routing
   drops make stream == drain and sharing on == off fail at this width, in
   the reference too: not asserted); per tier the param bytes, the decode
   step and the routed FFN's share of its device time; and layer 0's routed
   FFN on the card against the CPU on a 4 x 512 admission and 4 decode
   tokens: the same choices, the same dropped (token, choice) pairs,
   outputs within ``MOE_LAYER_TOL``, with the drops the padded tails cause.
12. danube  — h2o-danube-3-4b, head dim 120: the drain, paged
   decode and chunk kernels at D = 120 against their plain versions with
   phase 3's (danube's L shape, 32 heads over 8 kv heads, and its S tier's
   8 over 8; bf16 and int8 with garbage planted; the same bits twice),
   nested as ``danube`` in each kernel's entry; then, after the MoE
   phases, the published config (L 24 layers, 15.9 GB float32 params; S 6)
   through phase 4's drain, the stream trace's first 16 requests at theta
   0.6 and the median, and over int8 pools, asserting one host fetch per
   serve or tick and the launches the lane flags predict.
13. training — last: one reduced train step per arch of the registry,
   card against CPU on the same params (loss, grad norm, updated params);
   ``launch/train.run`` at full width on qwen2-1.5b and mamba2-370m (the
   loss falls; step ms, tokens/s, peak memory; ssd_chunk once a mamba
   layer a step, under autograd), and one full-width mamba2 layer's grads
   through the kernel against the plain path's; the paper's SML_CIFAR /
   LML_CIFAR trained on the card to ``tests/test_system.py``'s ordering,
   ``HICascade`` through hi_gate, a checkpoint round trip of both tiers;
   the three training examples at their ``--fast`` settings.
14. launch — the launch tooling.  The dry run (``launch/dryrun.py``) runs
   in a subprocess of its own from the build onwards, ``DRYRUN_JOBS``
   workers at nice 10, and is read last: ``--all --both-meshes`` (every
   config x shape at 256 and 512 ranks), ``--variant split_cache`` on the
   sliding-window archs and ``--hi`` over the decode shapes; one line of
   ok / skipped / errors and seconds per run, any error fails.  Right
   after phase 3, on an empty card: gemma3-1b at long_500k uncut (26
   layers, B 1, S 524,288, bf16 caches) decodes one step over the uniform
   cache and over the split cache built from it (ring slot s holds
   position p_s): logits within ``SPLIT_LOGIT_TOL``, the drain kernel once
   a layer a step on each path (counted per path), both caches' bytes
   and ms a step; the drain
   kernel against its plain version, SDPA and its bound at the two paths'
   shapes (nested as ``split_cache`` in its entry).  Then the reference's
   one-step HI serve (``specs.make_hi_decode_case``) on full-width
   qwen2-1.5b, decode_32k's length, batch cut to 32: the merged rows equal
   the tiers' own ``decode_step`` rows bit for bit, the arguments' bytes
   equal the dry run's, the step no faster than the roofline's largest
   term; the reckoned peak beside ``max_memory_allocated``'s rise.
15. the ``{"kernels": [...]}`` line (launches summed over every main-path
   run, each run's counts set to 0 just before it; the int8 bodies listed
   apart as ``name[int8]``), the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

TF32 is off for matmuls and cuDNN throughout, so float32 stays float32.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, float32
# outside the tensor cores (most kernels' arithmetic is float32 FMA), dense
# bf16 on the tensor cores (the chunk kernel's path) and dense TF32 (the
# SSD kernel's).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
TF32_TC_FLOP_PER_S = 495e12
# the chunk kernel runs each float32 product as three bf16 tensor-core
# passes (q and p as hi + mid + lo; csrc/chunk_paged_attention.cu)
CHUNK_TC_PASSES = 3
# the SSD kernel runs each float32 product as three TF32 tensor-core passes
# (lo.hi + hi.lo + hi.hi; csrc/ssd_scan.cu)
SSD_TC_PASSES = 3
L2_BYTES = 50 * 2 ** 20

# the families whose serving state is the pages alone (the kernels' launch
# counts follow the same lane flags)
ATTENTION_FAMILIES = ("dense", "moe", "vlm")

# main-path settings (full-width serve phase)
ARCH = "qwen2-1.5b"
N_REQUESTS, BATCH, BUCKETS = 16, 8, (128, 512)
MAX_NEW, CACHE_LEN, THETA, CAPACITY = 16, 1024, 0.6, 0.5
DECODE_POS = 520            # a mid-generation position of the 512 bucket

# stream-phase settings (full-width serve_stream).  Two choices make the
# prefix cache work on this trace:
# * the 248 bucket is not a multiple of the 16-position page, so a full
#   restore of a prompt in it copies its partial tail page (copy-on-write)
#   before appending; were every bucket a multiple of the page, no restore
#   would copy a page;
# * chunk_size 256: a chunked admission registers nothing in the prefix
#   index (its pages fill over several ticks), so with chunks of 64 no
#   prompt of the 224-token system prefix would ever be cached.  With 256,
#   the 248/256-bucket repeats take the admit lane and register, and the
#   512-bucket prompts take the chunk lane in two passes.
STREAM_KW = dict(buckets=(64, 128, 248, 256, 512), num_slots=8, l_slots=4,
                 page_size=16, decode_block=4, chunk_prefill=True,
                 chunk_size=256, chunk_width=2, validate=True)
SYS_PREFIX = 224            # repeated_prefix's shared system prompt
N_MIXED, N_REPEAT, N_LONG = 12, 12, 8
# the paged pools of that scheduler: 34 pages of 16 per slot (512 + 16 + 3
# positions), plus 2 * slots retained prompts of 32 pages
NPG = 34
L_PAGES = 4 * NPG + 1 + 8 * 32
S_PAGES = 8 * NPG + 1 + 16 * 32

# the mesh phase: the stream trace's first MESH_REQUESTS requests through
# the (1, 1) mesh and without it, bf16 and int8
MESH_REQUESTS = 16

# the fault phase: the stream trace under a seeded schedule (20% of
# escalation transits lost, an L outage over ticks 8..19 that opens the
# breaker, a latency spike over ticks 30..33), with retries and a breaker
# that opens after 2 consecutive failures and probes after 4 ticks
FAULTS = dict(seed=18, loss_prob=0.2, outages=((8, 20),), spikes=((30, 34),))
RETRY = dict(ack_timeout_ticks=2, max_retries=2, backoff_cap_ticks=4,
             breaker_threshold=2, breaker_cooldown_ticks=4)
# a pure delay: every transit takes 2..4 ticks, nothing is lost
DELAY = dict(seed=18, delay_ticks=2, delay_jitter=2)

# the speculative phase: the stream settings with the draft-verify lane on.
# Both tiers admit every request at one slot index, so the L tier has the S
# tier's 8 slots and pool (l_slots is not read); the verify chunk is q
# (8, decode_block, 12, 128) over that pool
SPEC_KW = dict(STREAM_KW, speculative=True)
SPEC_L_PAGES = S_PAGES
# the first SPEC_ORACLE requests are held against the port's host oracle
# (``TokenCascade.generate_speculative`` on the card): a request's tokens
# may part from the oracle's only at a position the oracle chose by a
# top1 - top2 margin under SPEC_MARGIN_TOL (the two paths' logits differ
# by the order of their float32 sums, far below it), and at least
# SPEC_MIN_EQUAL requests must equal the oracle's throughout
SPEC_ORACLE, SPEC_MIN_EQUAL, SPEC_MARGIN_TOL = 8, 4, 1e-2

# the recurrent families (SSM mamba2-370m at full size; hybrid zamba2-2.7b
# at full width, cut in depth: the reference cannot build its full-depth
# cascade, whose 13-layer S tier its groups of 6 do not divide)
SSM_ARCH, HYBRID_ARCH = "mamba2-370m", "zamba2-2.7b"
SSM_STREAM_KW = dict(STREAM_KW, chunk_prefill=False)
CHUNK_DEPTH = 8             # chunk-lane phase: mamba2 widths, 8 layers (S 2)
CHUNK_KW = dict(buckets=(128, 256), num_slots=4, l_slots=2, page_size=16,
                decode_block=4, chunk_prefill=True, chunk_size=64,
                chunk_width=2, validate=True)
HYBRID_DEPTH = 24           # zamba2: 4 groups of 6 (S: 6 layers, 3 groups)
HYBRID_KW = dict(buckets=(64, 128, 248, 256), num_slots=8, l_slots=4,
                 page_size=16, decode_block=4, prefix_sharing=True,
                 chunk_prefill=False, validate=True)
# its L tier's pool: 18 pages of 16 per slot (256 + 15 + 3 positions), plus
# 2 * 4 retained prompts of 16 pages
Z_NPG = 18
Z_L_PAGES = 4 * Z_NPG + 1 + 8 * 16

# the MoE family: deepseek-moe-16b at its published widths and depth (L 28
# layers, 64 routed experts of 1,408, top 6, 2 shared; S its s_variant(4):
# 7 layers, 16 experts of 352), through the drain, the stream trace's first
# MOE_REQUESTS requests over bf16 and int8 pools, and the speculative lane;
# arctic-480b (the dense residual) at reduced size only
MOE_ARCH, MOE_DENSE_RESIDUAL = "deepseek-moe-16b", "arctic-480b"
MOE_REQUESTS = 16
# llava-next-34b's attention: 56 heads over 8 kv heads of 128, a group of 7
LLAVA_GROUP7 = "llava-next-34b group 7"
# the full-width MoE layer's admission: 4 rows of the drain's 512 bucket
# (buckets (128, 512): prompts of 129..512 tokens), 957 of them padding
MOE_ADMISSION = (141, 236, 391, 323)
# card vs CPU on one full-width routed FFN (float32, TF32 off: sums of 2,048
# and 1,408 terms in another order)
MOE_LAYER_TOL = 1e-4

# h2o-danube-3-4b at its published widths and depth: head dim 120 in the
# three attention kernels; the stream trace's first DANUBE_REQUESTS requests
DANUBE_ARCH, DANUBE_REQUESTS = "h2o-danube-3-4b", 16

# the launch tooling.  The dry run (``launch/dryrun.py``) in a subprocess
# of its own, started after the build and read at the end: every
# (arch x shape x mesh) case at 256 and 512 ranks, then the split-cache
# decode over the sliding-window archs and the HI case over the decode
# shapes, DRYRUN_JOBS worker processes at a lower priority than the card's
# phases (beside them it moved none of their readings beyond the spread
# between runs; PERF.md, PR 23)
DRYRUN_JOBS = 4
# the HI case per arch over the decode shapes.  zamba2-2.7b's S tier
# (s_variant(4): 13 layers, not a multiple of its shared-attention period
# 6) cannot be built, in the reference too (ROADMAP Queue C): its run must
# fail with that error on every case it does not skip, and no other
HI_REFUSED = {"zamba2-2.7b": "must divide by shared_attn_every"}
# gemma3-1b's split-cache decode at long_500k, uncut: the uniform cache's
# rows < SPLIT_POS from a seed, the split cache built from them; logits of
# the two decodes within SPLIT_LOGIT_TOL (float32 params; the windowed
# layers' softmax merged in another split order, through 26 layers), ms a
# step by CUDA events over SPLIT_STEPS steps
SPLIT_ARCH, SPLIT_POS, SPLIT_STEPS = "gemma3-1b", 524_000, 20
SPLIT_LOGIT_TOL = 1e-3
# the reference's one-step HI serve (``specs.make_hi_decode_case``) on
# full-width qwen2-1.5b at decode_32k's seq_len, the batch cut 128 -> 32
# (at 128 its arguments alone take ~75 GB): capacity 16
HI_ARCH, HI_BATCH, HI_STEPS = "qwen2-1.5b", 32, 10

# training on the card.  Reduced, one step per arch, card vs CPU (float32
# with TF32 off: sums in another order): loss and grad norm within
# TRAIN_RTOL, updated params within lr, all but TRAIN_OFF_SHARE of them
# within TRAIN_RTOL.  Full width (``launch/train.run``): TRAIN_STEPS steps
# of TRAIN_BATCH x TRAIN_SEQ tokens at TRAIN_LR (``run``'s default 1e-3,
# with one warmup step, made full-width qwen2-1.5b's loss climb from its
# second step: 12.38 -> 9.60 -> 11.58 ... 19.14 on the card).  ssd_chunk's grads through the kernel
# vs the plain path on one full-width layer, as a share of each grad's
# largest magnitude (the kernel's three TF32 passes move the forward's
# activations by ~1e-6 of their scale)
TRAIN_RTOL, TRAIN_OFF_SHARE = 1e-4, 1e-3
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 4, 512, 1e-4
SSD_GRAD_TOL = 1e-4

# the reference's byte contract for int8 pools against bf16 on qwen2
# (benchmarks/bench_serving.py, asserted <= 0.55x)
INT8_MAX_RATIO = 0.55

# the sampler's bits on the card: a fixed (request seed, token index) grid
# at qwen2's vocab; its keys and the first and last two bits of each row,
# generated with jax (tests/test_torch_sampler.py checks them against jax)
SAMPLER_VOCAB = 151_936
SAMPLER_SEEDS = (0, 1, 7, 31, 12345, 65535, 1000003, 2 ** 31 - 1)
SAMPLER_IDX = (0, 1, 2, 3, 15, 16, 100, 2 ** 31 - 1)
SAMPLER_KEYS = ((1797259609, 2579123966), (1948878966, 4237131848),
                (966301609, 1948237315), (4191038410, 4045769906),
                (1129288793, 111391168), (2002551412, 2027354116),
                (2408512133, 1374696441), (375109920, 4169173816))
SAMPLER_BITS = ((3617712097, 783310428, 2050723640, 4291114161),
                (1733648124, 2357486511, 231193668, 1609519782),
                (884754664, 1109997517, 3926712195, 3365585778),
                (2617041338, 104242795, 2120560266, 1356952859),
                (935579544, 2940652993, 3026431569, 1756190098),
                (1225084740, 3105217150, 1696176773, 1974551068),
                (2782424888, 3351575534, 841076450, 3380150124),
                (2111541414, 1345954618, 171566650, 609683880))

# the classifier cascade (``cascade_phase``): the paper's CIFAR-10 test
# size of ``data/images``, in batches; predictions compared where the S
# tier's top1 - top2 probability margin exceeds CASCADE_MARGIN
CASCADE_IMAGES, CASCADE_BATCH, CASCADE_DATA_SEED = 10_000, 2_000, 7
CASCADE_SEED, CASCADE_MARGIN, CASCADE_CAPACITY = 19, 1e-4, 0.4
# the legacy baseline (``legacy_phase``): one batch of 8 random prompts at
# bucket 128; serve and serve_legacy differ by the order of float32 sums
# (batched prefill against per-token decode) and the bf16 K/V roundings
# that order moves: tokens compared up to the first teacher-forced logit
# margin under LEGACY_MARGIN, mean confidences to LEGACY_CONF_TOL
LEGACY_SEED, LEGACY_BUCKET = 19, 128
LEGACY_MARGIN, LEGACY_CONF_TOL = 5e-2, 1e-5
# temperature sampling (``temperature_phase``): a sampled token is compared
# where the margin of logits / t + gumbel exceeds SAMPLE_MARGIN: the
# stream's paged kernels and the drain's contiguous path sum in other
# orders, which moves bf16 K/V roundings and so the logits, by far more
# than the order of float32 sums alone
TEMPERATURE, SAMPLE_MARGIN = 0.7, 5e-2

# tolerances of kernel vs plain version (both float32 arithmetic; only the
# order of the sums differs)
CONF_ATOL, CONF_RTOL = 1e-5, 1e-4        # over 151,936 exp terms
ATT_ATOL = 1e-4                          # over <= 1,024 positions
SMALL_LOGIT_TOL = 5e-3                   # card vs CPU, small model, bf16 K/V
SMALL_FWD_TOL = 1e-3                     # card vs CPU, small float32 forward
SSD_ATOL, SSD_RTOL = 1e-4, 1e-4          # ssd_chunk, sums of <= 128 terms
# chunk lane (W rows) vs the same per-token steps on a one-row contiguous
# cache: the same float32 arithmetic, products of another batch size
CHUNK_LOGIT_TOL = 1e-3


T0 = time.perf_counter()


def log(*a):
    """Print at once; a phase header ("== ...") carries the seconds since
    the script started, so a run shows where its time limit goes."""
    if a and str(a[0]).startswith("=="):
        a = (f"{a[0]} [{time.perf_counter() - T0:.1f} s]",) + a[1:]
    print(*a, flush=True)


def timed(fn, args_list, iters, warmup=5):
    """Mean ms per call over ``iters`` calls, cycling through ``args_list``
    (copies whose total exceeds the L2 cache, so each call reads cold HBM as
    the main path does)."""
    import torch
    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, args_list, pattern, launches=1, iters=50, attempts=3):
    """Device time per call, in ms, from ``iters`` calls under
    ``torch.profiler`` (CUPTI's kernel durations from the Chrome trace: what
    the card spent, without the host's submission time that back-to-back
    CUDA-event timing also sees when the host is the slower side).
    ``launches`` is the kernel launches one call makes (the drain kernel's
    two: its splits and their merge).  The records whose name matches
    ``pattern`` are grouped by kernel name, and the time is the sum over
    the names of the mean duration of one record times that kernel's
    launches per call: so a record that CUPTI dropped (it loses one now and
    then, in some runs in every window) neither shortens nor lengthens the
    time.  A window is used when its names make up ``launches`` per call
    and at most a tenth of the records are missing; else it is profiled
    again, up to ``attempts`` windows in all, and then this raises."""
    import re
    import tempfile
    from statistics import fmean
    import torch
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    want = iters * launches
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*args_list[i % len(args_list)])
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "t.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        durs = {}
        for e in events:
            if e.get("cat") == "kernel" and re.search(pattern, e["name"]):
                durs.setdefault(e["name"], []).append(float(e["dur"]))
        seen = sum(len(d) for d in durs.values())
        per_call = {name: round(len(d) / iters) for name, d in durs.items()}
        if (sum(per_call.values()) == launches
                and all(per_call.values())
                and want - iters // 10 <= seen <= want):
            if seen < want:
                log(f"  (profiler window {attempt}: {seen} records of "
                    f"{pattern!r} for {iters} calls x {launches}; each "
                    f"kernel's mean record used)")
            return sum(fmean(d) * per_call[name]
                       for name, d in durs.items()) / 1e3
        log(f"  (profiler window {attempt}: {seen} records of {pattern!r} "
            f"in {sorted(per_call.items())}, not {iters} calls x "
            f"{launches}; not used)")
    raise AssertionError(f"profiler saw {seen} launches of {pattern!r}, not "
                         f"{iters} calls x {launches}, in each of "
                         f"{attempts} windows")


def graph_ms(fn, args_list, calls=100):
    """Device time per call, in ms, with no host submission in the window:
    CUDA events around one replay of a CUDA graph of ``calls`` back-to-back
    calls, cycling through ``args_list`` (warmed up on the capture stream,
    and the graph replayed once, first).  The wrappers' launch counters
    move while the graph is captured, not while it replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(*args_list[i % len(args_list)])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(calls):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / calls


def host_ms(fn, args_list, iters=200):
    """The host's time per call, in ms: ``time.perf_counter`` around
    ``iters`` calls with no synchronisation inside the window (what the
    wrapper costs the thread that submits, not the card's time)."""
    import torch
    for i in range(5):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def copies(make, nbytes):
    """Enough independent input sets to exceed the L2 cache twice over."""
    return [make() for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)))]


def bound(nbytes, flops, flop_per_s=F32_FLOP_PER_S):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# hi_gate's timed shapes: (label, N, C); the first is the main row; the
# last is the classifier cascade's (a 2,000-image batch of CIFAR logits),
# also timed in entropy, its costliest metric
GATE_SHAPES = (("S tier qwen2-1.5b", 8, 151_936),
               ("L tier qwen2-1.5b", 4, 151_936),
               ("chunk lane qwen2-1.5b", 2, 151_936),
               ("S tier mamba2-370m", 8, 50_280),
               ("S tier zamba2-2.7b", 8, 32_000),
               ("cascade SML_CIFAR", 2000, 10))
CASCADE_GATE = GATE_SHAPES[-1]


def gate_times(gate, gen, n, c):
    """``gate`` on fresh (n, c) float32 logits: CUDA events over 200 calls,
    the profiler's device time and a CUDA-graph replay, in ms; and the
    input sets, for more timings on the same inputs."""
    import torch
    sets = copies(lambda: (torch.randn((n, c), generator=gen,
                                       device="cuda"),), n * c * 4)
    return sets, {"ms": timed(gate, sets, 200),
                  "device_ms": device_ms(gate, sets, r"hi_gate"),
                  "graph_ms": graph_ms(gate, sets)}


def check_hi_gate(gen, shapes=GATE_SHAPES):
    """hi_gate against its plain version at ``shapes`` (every metric, f32
    and bf16), then timed at each; returns the first shape's entry of the
    kernels line (the cascade's shape nested in it)."""
    import torch
    from repro_torch.kernels import hi_gate as hg
    worst, rows = 0.0, []
    for _, n, c in shapes:
        for metric in ("max_prob", "margin", "entropy"):
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randn((n, c), generator=gen, device="cuda") * 3)
                # a max duplicated across splits, and one in the last split
                first = min(7, c // 2)
                x[0, 7] = x[0, c // 2] = x[0].max() + 2.0
                x[n - 1, c - 1] = x[n - 1].max() + 1.0
                x = x.to(dtype)
                conf_p, pred_p, _ = hg.hi_gate_plain(x, 0.0, metric)
                # a row exactly at theta
                theta = conf_p[1:2].reshape(()).clone()
                conf_k, pred_k, off_k = hg.hi_gate_cuda(x, theta, metric)
                torch.cuda.synchronize()
                err = (conf_k - conf_p).abs()
                if not bool((err <= CONF_ATOL + CONF_RTOL * conf_p.abs()).all()):
                    raise AssertionError(f"hi_gate {metric} n={n} {dtype}: "
                                         f"max err {err.max().item():.3e}")
                if (not torch.equal(pred_k, pred_p)
                        or int(pred_k[0]) != first
                        or int(pred_k[n - 1]) != c - 1):
                    raise AssertionError(f"hi_gate {metric}: argmax differs")
                if metric == "margin" and float(conf_k[0]) != 0.0:
                    raise AssertionError("hi_gate margin: duplicated max != 0")
                if not torch.equal(off_k, (conf_k < theta).to(torch.int32)):
                    raise AssertionError("hi_gate: offload != conf < theta")
                worst = max(worst, err.max().item())
                rows.append((n, c, metric, str(dtype)[6:], err.max().item()))
    for r in rows:
        log(f"  hi_gate n={r[0]} C={r[1]} {r[2]:8s} {r[3]:8s} max_abs_err "
            f"{r[4]:.2e} (tol {CONF_ATOL:g} + {CONF_RTOL:g}*|conf|)")

    # timing at each path shape, float32 logits, max_prob (and entropy at
    # the cascade's shape)
    theta = torch.tensor(THETA, device="cuda")
    main = None
    cases = [(label, n, c, "max_prob") for label, n, c in shapes]
    if CASCADE_GATE in shapes:
        cases.append(CASCADE_GATE + ("entropy",))
    for label, n, c, metric in cases:
        def gate(x):
            return hg.hi_gate_cuda(x, theta, metric)

        nbytes = n * c * 4
        sets, t = gate_times(gate, gen, n, c)
        ms, dev_ms, g_ms = t["ms"], t["device_ms"], t["graph_ms"]
        plain_ms = timed(lambda x: hg.hi_gate_plain(x, theta, metric),
                         sets, 50)
        # the nearest PyTorch calls: two of them (no single call computes
        # the gate), so no library yardstick
        two_ms = timed(lambda x: torch.softmax(x, -1).max(-1), sets, 200)
        # entropy: exp, log and a product-sum per element on top
        flops = (6 if metric != "entropy" else 9) * n * c
        bound_ms, by = bound(nbytes + n * 12 + 4, flops)
        log(f"  hi_gate {label} ({n}, {c}) f32 {metric}, "
            f"{hg.gate_splits(n, c)} splits: {ms * 1e3:.1f} us (device "
            f"{dev_ms * 1e3:.2f} us; graph {g_ms * 1e3:.2f} us)  plain "
            f"{plain_ms * 1e3:.1f} us  bound {bound_ms * 1e3:.3f} us ({by})  "
            f"softmax().max(), two calls, no single-call equivalent: "
            f"{two_ms * 1e3:.1f} us")
        entry = {"shape": f"logits ({n}, {c}) float32, {metric}",
                 "max_abs_err": worst, "ms": ms, "device_ms": dev_ms,
                 "graph_ms": g_ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": by, "library_ms": None}
        if main is None:
            main = {"name": "hi_gate", "route": "cuda",
                    "source": "src/repro_torch/csrc/hi_gate.cu",
                    "replaces": "src/repro/kernels/hi_gate.py:69", **entry}
        elif (n, c) == CASCADE_GATE[1:]:
            # the classifier cascade's shape, nested beside the main row
            main.setdefault("cascade", []).append(entry)
    return main


def _attn_case(gen, b, h, k, d, s, valid, dtype):
    import torch
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda")
    ck = torch.randn((b, s, k, d), generator=gen, device="cuda").to(dtype)
    cv = torch.randn((b, s, k, d), generator=gen, device="cuda").to(dtype)
    return q, ck, cv, valid


def check_decode_attention(gen, shapes=None):
    """The drain kernel against its plain version; ``shapes`` (label, B, H,
    K, D) over bf16 caches replace the main path's cases.  Returns the
    first case's entry of the kernels line."""
    import torch
    s = CACHE_LEN
    kpos = torch.arange(s, device="cuda")
    upto = kpos <= DECODE_POS
    window = upto & (DECODE_POS - kpos < 256)
    cases = [  # (label, B, H, K, D, valid, cache dtype)
        ("L tier qwen2-1.5b", 4, 12, 2, 128, upto, torch.bfloat16),
        ("S tier qwen2-1.5b-s4", 8, 3, 1, 128, upto, torch.bfloat16),
        ("gemma3-1b window 256", 4, 4, 1, 256, window, torch.bfloat16),
        ("L tier, f32 cache", 4, 12, 2, 128, upto, torch.float32),
    ] if shapes is None else [x + (upto, torch.bfloat16) for x in shapes]
    entries = [drain_case(gen, *case) for case in cases]
    main = entries[0]
    main["max_abs_err"] = max(e["max_abs_err"] for e in entries)
    return main


def drain_case(gen, label, b, h, k, d, valid, dtype):
    """One case of the drain kernel against its plain version, over a
    (B, S, K, D) cache of ``dtype`` with S = ``valid``'s length: the
    error, CUDA-event and profiler times, the plain version's, one SDPA
    call's and the bound.  Returns its entry of the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    s = valid.shape[0]
    args = _attn_case(gen, b, h, k, d, s, valid, dtype)
    out_k = da.decode_attention_cuda(*args)
    out_p = da.decode_attention_plain(*args)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    if not err <= ATT_ATOL or not bool(torch.isfinite(out_k).all()):
        raise AssertionError(f"decode_attention {label}: max err {err:.3e}")
    n_valid = int(valid.sum())
    isz = torch.tensor([], dtype=dtype).element_size()
    nbytes = (b * h * d * 4 * 2 + 2 * b * n_valid * k * d * isz + s)
    sets = copies(lambda: _attn_case(gen, b, h, k, d, s, valid, dtype),
                  2 * b * s * k * d * isz)
    ms = timed(da.decode_attention_cuda, sets, 200)
    dev_ms = device_ms(da.decode_attention_cuda, sets,
                       r"decode_attention_(split|combine)_kernel",
                       launches=2)
    plain_ms = timed(da.decode_attention_plain, sets, 50)
    # the library yardstick: one SDPA call on bf16 (B, H, 1, D) queries
    # over (B, K, S, D) K/V with the same mask; layouts made beforehand
    lib_sets = [(q.transpose(1, 2).to(dtype),
                 ck.transpose(1, 2).contiguous(),
                 cv.transpose(1, 2).contiguous(), m[None, None, None, :])
                for q, ck, cv, m in sets]
    lib_ms = timed(lambda q, kk, vv, m: F.scaled_dot_product_attention(
        q, kk, vv, attn_mask=m, enable_gqa=True), lib_sets, 200)
    bound_ms, by = bound(nbytes, 4 * b * h * n_valid * d)
    log(f"  decode_attention {label}: B={b} H={h} K={k} D={d} S={s} "
        f"valid={n_valid} {str(dtype)[6:]}  max_abs_err {err:.2e} (tol "
        f"{ATT_ATOL:g})  {ms * 1e3:.1f} us (device {dev_ms * 1e3:.1f} us)"
        f"  plain {plain_ms * 1e3:.1f} us"
        f"  sdpa {lib_ms * 1e3:.1f} us  bound {bound_ms * 1e3:.2f} us "
        f"({by})")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:123",
            "shape": (f"{label}: q ({b},1,{h},{d}) f32, K/V "
                      f"({b},{s},{k},{d}) {str(dtype)[6:]}, {n_valid} valid"),
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": lib_ms}


def _paged_case(gen, b, h, k, pages, pos, c, d=128, npg=NPG, plant=False,
                quant=False):
    """A main-path paged input: a (pages, 16, K, D) bf16 pool, each slot's
    ``npg``-page block row drawn without repeats from shuffled pages,
    queries at positions pos[b] .. pos[b] + c - 1.  ``quant``: int8 pools
    with their (pages, K) float32 scales instead.  ``plant``: garbage in
    every pool position no query may see (page 0, stale page tails, pages
    no slot sees), which the kernel must never let into a result: NaN and
    inf in a bf16 pool; for int8, arbitrary bytes there and NaN / inf
    scales on every page no query of its slot reaches.  Returns (q, pool_k,
    pool_v, block, valid, scales), scales () for bf16 or (scale_k,
    scale_v)."""
    import torch
    page = 16
    if quant:
        pool_k, pool_v = (torch.randint(-128, 128, (pages, page, k, d),
                                        generator=gen, device="cuda")
                          .to(torch.int8) for _ in range(2))
        scales = tuple(torch.rand((pages, k), generator=gen, device="cuda")
                       * 0.05 for _ in range(2))
    else:
        pool_k = torch.randn((pages, page, k, d), generator=gen,
                             device="cuda").to(torch.bfloat16)
        pool_v = torch.randn((pages, page, k, d), generator=gen,
                             device="cuda").to(torch.bfloat16)
        scales = ()
    perm = torch.randperm(pages - 1, generator=gen, device="cuda") + 1
    block = perm[: b * npg].to(torch.int32).reshape(b, npg)
    q = torch.randn((b, c, h, d), generator=gen, device="cuda")
    qpos = torch.as_tensor(pos, device="cuda")[:, None] + \
        torch.arange(c, device="cuda")[None, :]
    kpos = torch.arange(npg * page, device="cuda")
    valid = kpos[None, None, :] <= qpos[:, :, None]
    if plant:
        hidden = ~valid.any(dim=1)                    # (B, S_tot)
        phys = block.long()[:, kpos // page] * page + kpos % page
        bad = ((-128, -128) if quant else (float("nan"), float("inf")))
        for pool, x in zip((pool_k, pool_v), bad):
            pool.view(-1, k, d)[phys[hidden]] = x
            pool[0] = x
        if quant:
            seen = (~hidden).reshape(b, npg, page).any(dim=2)
            dark = torch.ones(pages, dtype=torch.bool, device="cuda")
            dark[block[seen].long()] = False
            scales[0][dark], scales[1][dark] = float("nan"), float("inf")
    return q, pool_k, pool_v, block, valid, scales


def _paged_library(q, pool_k, pool_v, block, valid, *scales):
    """Yardstick inputs: K/V gathered through the block table (and, for
    int8, dequantised) beforehand into (B, K, S, D) bf16, so one SDPA call
    computes the same function."""
    import torch
    from repro_torch.kernels.decode_attention import dequant_gather

    def gather(pool, scale):
        return dequant_gather(pool, scale, block).transpose(1, 2) \
            .to(torch.bfloat16).contiguous()

    sk, sv = scales or (None, None)
    return (q.transpose(1, 2).to(torch.bfloat16), gather(pool_k, sk),
            gather(pool_v, sv), valid[:, None])


def _sdpa(q, kk, vv, m):
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, kk, vv, attn_mask=m,
                                          enable_gqa=True)


def _gather_sdpa(q, pool_k, pool_v, block, valid, *scales):
    return _sdpa(*_paged_library(q, pool_k, pool_v, block, valid, *scales))


def check_paged(gen, name, c, cases, quant=False, graph=False):
    """Kernels 3 and 4 (one source): each case is (label, B, H, K, D, pages,
    first query positions, pages per slot, plant garbage).  ``quant``: the
    int8 bodies, over int8 pools and their scales; a planted case must also
    give bit for bit what the same inputs give without the garbage.  The
    main path's L-tier case is timed first.  The decode kernel, and the
    chunk kernel where ``graph``, are also timed by a CUDA-graph replay."""
    import torch
    from repro_torch.kernels import decode_attention as da
    kernel = (da.decode_attention_paged_cuda if c == 1
              else da.decode_attention_chunk_paged_cuda)
    plain = (da.decode_attention_paged_plain if c == 1
             else da.decode_attention_chunk_paged_plain)
    # C = 1 is the decode kernel (keys split across blocks, one launch a
    # call), C > 1 the chunk kernel (tensor cores)
    pattern = (r"paged_attention_split_kernel" if c == 1
               else r"chunk_paged_attention_kernel")
    source = ("src/repro_torch/csrc/decode_attention_paged.cu" if c == 1
              else "src/repro_torch/csrc/chunk_paged_attention.cu")
    kind = "int8" if quant else "bf16"

    def mask(valid):
        return valid[:, 0] if c == 1 else valid

    def args(case):
        q, pk, pv, block, valid, scales = case
        return (q, pk, pv, block, mask(valid), *scales)

    worst, main = 0.0, None
    for label, b, h, k, d, pages, pos, npg, plant in cases:
        case = _paged_case(gen, b, h, k, pages, pos, c, d, npg, plant, quant)
        out_k = kernel(*args(case))
        out_p = plain(*args(case))
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        if not err <= ATT_ATOL or not bool(torch.isfinite(out_k).all()):
            raise AssertionError(f"{name} {label}: max err {err:.3e}")
        if quant and plant:
            # the same inputs with other values wherever nothing is read:
            # finite scales, other bytes in the unseen rows
            q, pk, pv, block, valid, scales = case
            hidden = ~valid.any(dim=1)
            phys = (block.long()[:, :, None] * 16
                    + torch.arange(16, device="cuda")).reshape(b, -1)
            other = tuple(torch.where(torch.isfinite(t), t, 0.5)
                          for t in scales)
            opk, opv = pk.clone(), pv.clone()
            for t in (opk, opv):
                t.view(-1, k, d)[phys[hidden]] = 3
            if not torch.equal(kernel(q, opk, opv, block, mask(valid),
                                      *other), out_k):
                raise AssertionError(f"{name} {label}: the garbage planted "
                                     "where no query looks changed the "
                                     "output")
        worst = max(worst, err)
        q, pk, _, block, valid, scales = case
        seen = valid.any(dim=1)                      # keys any query sees
        n_seen, n_pairs = int(seen.sum()), int(valid.sum())
        pages_seen = int(seen.reshape(b, npg, 16).any(dim=2).sum())
        item = pk.element_size()
        nbytes = (2 * b * c * h * d * 4 + 2 * n_seen * k * d * item
                  + (2 * pages_seen * k * 4 if quant else 0)
                  + valid.numel() + block.numel() * 4)
        sets = copies(lambda: _paged_case(gen, b, h, k, pages, pos, c, d,
                                          npg, plant, quant),
                      2 * pk.numel() * item)
        msets = [args(x) for x in sets]
        ms = timed(kernel, msets, 200)
        dev_ms = device_ms(kernel, msets, pattern)
        # the decode kernel is also timed as a CUDA graph, with no host
        # submission in the window
        g_ms = graph_ms(kernel, msets) if c == 1 or graph else None
        plain_ms = timed(plain, msets, 20)
        raw = [(x[0], x[1], x[2], x[3], x[4], *x[5]) for x in sets]
        lib_sets = [_paged_library(*x) for x in raw]
        lib_ms = timed(_sdpa, lib_sets, 200)
        gather_ms = timed(_gather_sdpa, raw, 50)
        flops = 4 * h * d * n_pairs
        f32_ms, f32_by = bound(nbytes, flops)
        if c == 1:
            bound_ms, by = f32_ms, f32_by
            bounds = f"bound {bound_ms * 1e3:.2f} us ({by})"
        else:
            # the path the kernel takes: every float32 product as
            # CHUNK_TC_PASSES bf16 tensor-core passes
            bound_ms, by = bound(nbytes, CHUNK_TC_PASSES * flops,
                                 BF16_TC_FLOP_PER_S)
            bounds = (f"bound {bound_ms * 1e3:.2f} us ({by}, "
                      f"{CHUNK_TC_PASSES} bf16 tensor-core passes; float32 "
                      f"FMA bound {f32_ms * 1e3:.2f} us)")
        pool = f"({pages},16,{k},{d}) {kind}"
        log(f"  {name} {label}: B={b} C={c} H={h} K={k} D={d} pool {pool}"
            f"{' + (P,K) f32 scales' if quant else ''}, {n_pairs} (query, "
            f"key) pairs{', garbage planted where no query looks' if plant else ''}"
            f"  max_abs_err {err:.2e} (tol {ATT_ATOL:g})  {ms * 1e3:.1f} us "
            f"(device {dev_ms * 1e3:.1f} us"
            f"{'' if g_ms is None else f', graph {g_ms * 1e3:.1f} us'})  "
            f"plain {plain_ms * 1e3:.1f} us  sdpa on gathered "
            f"{'dequantised ' if quant else ''}K/V {lib_ms * 1e3:.1f} us  "
            f"gather+sdpa {gather_ms * 1e3:.1f} us  {bounds}")
        if main is None:
            main = {"name": name + ("[int8]" if quant else ""),
                    "route": "cuda", "source": source,
                    "replaces": (("src/repro/kernels/decode_attention.py:192"
                                  if quant else
                                  "src/repro/kernels/decode_attention.py:376")
                                 if c == 1 else
                                 ("src/repro/kernels/decode_attention.py:265"
                                  if quant else
                                  "src/repro/kernels/decode_attention.py:307")),
                    "shape": (f"{label}: q ({b},{c},{h},{d}) f32, pool "
                              f"{pool}, {n_pairs} pairs"),
                    "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by,
                    "library_ms": lib_ms, "gather_sdpa_ms": gather_ms}
            if g_ms is not None:
                main["graph_ms"] = g_ms
    main["max_abs_err"] = worst
    return main


def _decode_positions():
    """The decode cases' query positions: qwen2's L and S tiers (prompts of
    32..527), zamba2's L tier (32..271); the int8 cases take the same."""
    import numpy as np
    rng = np.random.default_rng(3)
    return (rng.integers(32, 528, 4).tolist(),
            rng.integers(32, 528, 8).tolist(),
            rng.integers(32, 272, 4).tolist())


def check_decode_attention_paged(gen):
    pos_l, pos_s, pos_z = _decode_positions()
    return check_paged(gen, "decode_attention_paged", 1, [
        ("L tier qwen2-1.5b", 4, 12, 2, 128, L_PAGES, pos_l, NPG, False),
        ("S tier qwen2-1.5b-s4", 8, 3, 1, 128, S_PAGES, pos_s, NPG, False),
        # zamba2's shared block: 32 heads over 32 kv heads of 80
        ("L tier zamba2-2.7b", 4, 32, 32, 80, Z_L_PAGES, pos_z, Z_NPG,
         True)])


def check_decode_attention_chunk_paged(gen):
    # chunk_width 2 rows of chunk_size 256: a 512-bucket prompt's first
    # chunk and another's second (positions 256..511)
    c = STREAM_KW["chunk_size"]
    return check_paged(gen, "decode_attention_chunk_paged", c, [
        ("L tier qwen2-1.5b", 2, 12, 2, 128, L_PAGES, [0, 512 - c], NPG,
         False),
        ("S tier qwen2-1.5b-s4", 2, 3, 1, 128, S_PAGES, [0, 512 - c], NPG,
         False)])


def check_decode_attention_paged_int8(gen):
    """The int8 body at the main path's decode shapes: qwen2-1.5b's L tier
    at head dim 128 and zamba2-2.7b's shared block at 80, both with
    garbage planted where no query looks, at the bf16 cases' positions."""
    pos_l, _, pos_z = _decode_positions()
    return check_paged(gen, "decode_attention_paged", 1, [
        ("L tier qwen2-1.5b", 4, 12, 2, 128, L_PAGES, pos_l, NPG, True),
        ("L tier zamba2-2.7b", 4, 32, 32, 80, Z_L_PAGES, pos_z, Z_NPG,
         True)], quant=True)


def check_decode_attention_chunk_paged_int8(gen):
    c = STREAM_KW["chunk_size"]
    return check_paged(gen, "decode_attention_chunk_paged", c, [
        ("L tier qwen2-1.5b", 2, 12, 2, 128, L_PAGES, [0, 512 - c], NPG,
         True)], quant=True)


def check_copy_pages(gen, quant=False, cases=None):
    """Kernel 5 on a tier's K and V pools at the main path's shapes: the
    pools are NaN except the source pages, so a stray write shows.
    ``quant``: int8 pools and their (L, P, K) float32 scale rows in the
    same launch, at qwen2-1.5b's K = 2 (8-byte rows) and zamba2-2.7b's
    K = 32 (128-byte rows); the untouched pages hold -128 and NaN scales."""
    import numpy as np
    import torch
    from repro_torch.kernels import copy_pages as cp
    main = None
    cases = cases or ((("L tier qwen2-1.5b", 28, L_PAGES, 2, 128, 4),
                       ("L tier zamba2-2.7b", HYBRID_DEPTH // 6, Z_L_PAGES,
                        32, 80, 4)) if quant else
                      (("L tier qwen2-1.5b", 28, L_PAGES, 2, 128, 4),
                       ("S tier qwen2-1.5b-s4", 7, S_PAGES, 1, 128, 8)))
    for label, layers, pages, k, d, pairs in cases:
        shape = (layers, pages, 16, k, d)

        def make():
            perm = torch.randperm(pages - 1, generator=gen,
                                  device="cuda").cpu().numpy() + 1
            src = perm[:pairs].astype(np.int32)
            dst = perm[pairs:2 * pairs].astype(np.int32)
            if quant:
                pools = [torch.full(shape, -128, dtype=torch.int8,
                                    device="cuda") for _ in range(2)]
                rows = [torch.full((layers, pages, k), float("nan"),
                                   device="cuda") for _ in range(2)]
                for t in pools:
                    t[:, src] = torch.randint(
                        -127, 128, (layers, pairs) + shape[2:],
                        generator=gen, device="cuda").to(torch.int8)
                for t in rows:
                    t[:, src] = torch.rand((layers, pairs, k), generator=gen,
                                           device="cuda")
                return tuple(pools + rows), src, dst
            pools = [torch.full(shape, float("nan"), device="cuda")
                     .to(torch.bfloat16) for _ in range(2)]
            for t in pools:
                t[:, src] = torch.randn((layers, pairs) + shape[2:],
                                        generator=gen, device="cuda") \
                    .to(torch.bfloat16)
            return tuple(pools), src, dst

        tensors, src, dst = make()
        want = tuple(t.clone() for t in tensors)
        cp.copy_pages_plain(want, src, dst)
        cp.copy_pages_cuda(tensors, src, dst)
        torch.cuda.synchronize()
        for got, ref in zip(tensors, want):
            if not torch.equal(got.view(torch.uint8), ref.view(torch.uint8)):
                raise AssertionError(f"copy_pages {label}: bytes differ from "
                                     "the plain version's")
        # read + write of each copied page (and scale row) of each tensor
        nbytes = 2 * pairs * sum(t[0, 0].numel() * t.element_size() * layers
                                 for t in tensors)
        sets = copies(make, sum(t.numel() * t.element_size()
                                for t in tensors))
        ms = timed(cp.copy_pages_cuda, sets, 200)
        wrapper_ms = host_ms(cp.copy_pages_cuda, sets)
        dev_ms = device_ms(cp.copy_pages_cuda, sets, r"copy_pages_kernel")
        plain_ms = timed(cp.copy_pages_plain, sets, 50)
        lib_sets = [(p, torch.as_tensor(d_, device="cuda").long(),
                     tuple(t[:, torch.as_tensor(s_, device="cuda").long()]
                           for t in p)) for p, s_, d_ in sets]

        def index_copy(p, d_, srcs):
            for t, x in zip(p, srcs):
                t.index_copy_(1, d_, x)

        lib_ms = timed(index_copy, lib_sets, 200)
        bound_ms, by = bound(nbytes, 0)
        what = (f"2 int8 pools ({layers},{pages},16,{k},{d}) + 2 f32 scale "
                f"rows ({layers},{pages},{k})" if quant else
                f"2 pools ({layers},{pages},16,{k},{d}) bf16")
        log(f"  copy_pages {label}: {what}, {pairs} pairs, one launch  exact"
            f"  {ms * 1e3:.1f} us (device {dev_ms * 1e3:.2f} us; host "
            f"{wrapper_ms * 1e3:.1f} us a call)  plain "
            f"{plain_ms * 1e3:.1f} us  index_copy_ (one per tensor, sources "
            f"gathered beforehand) {lib_ms * 1e3:.1f} us  bound "
            f"{bound_ms * 1e3:.2f} us ({by})")
        if main is None:
            main = {"name": "copy_pages[int8]" if quant else "copy_pages",
                    "route": "cuda",
                    "source": "src/repro_torch/csrc/copy_pages.cu",
                    "replaces": "src/repro/kernels/decode_attention.py:206",
                    "shape": f"{label}: {what}, {pairs} pairs",
                    "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms,
                    "host_ms": wrapper_ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by,
                    "library_ms": lib_ms}
    return main


def _ssd_case(gen, b, nc, q, h, p, n, live=None):
    import torch
    x = torch.randn((b, nc, q, h, p), generator=gen, device="cuda")
    # softplus-range steps; a right-padded row's tail carries dt = 0
    dt = torch.rand((b, nc, q, h), generator=gen, device="cuda") * 0.5
    if live is not None:
        dt[:, :, live:] = 0.0
    A = -torch.rand((h,), generator=gen, device="cuda") - 0.2
    B = torch.randn((b, nc, q, n), generator=gen, device="cuda")
    C = torch.randn((b, nc, q, n), generator=gen, device="cuda")
    return x, dt, A, B, C


def ssd_bound(b, nc, q, h, p, n):
    """(bytes, float32 operations) of one ssd_chunk call: every input read
    once and every output written once; C.B^T and the y_diag sums over
    j <= i only (the causal half the data needs), S over every j.  The
    kernel's path runs each operation as SSD_TC_PASSES TF32 tensor-core
    passes."""
    nbytes = 4 * (2 * b * nc * q * h * p + 2 * b * nc * q * h
                  + 2 * b * nc * q * n + h + b * nc * h * p * n + b * nc * h)
    tri = q * (q + 1) // 2
    flops = 2 * b * nc * (tri * n + h * (tri * p + q * p * n))
    return nbytes, flops


def check_ssd_chunk(gen):
    """Kernel 6 at the main path's admission shapes (mamba2-370m L: 4 rows
    of the 512 bucket; S: 8 rows; zamba2-2.7b L: 4 rows of the 256 bucket),
    all four outputs against the plain version; then the padded-tail
    exactness (dt = 0 past the length: S unmoved by x there, g equal to
    exp(a_cs) at the length, bit for bit)."""
    import torch
    from repro_torch.kernels import ssd_scan
    cases = [  # (label, b, nc, Q, H, P, N)
        ("L tier mamba2-370m", 4, 4, 128, 32, 64, 128),
        ("S tier mamba2-370m-s4", 8, 4, 128, 8, 64, 128),
        ("L tier zamba2-2.7b", 4, 2, 128, 80, 64, 64),
    ]
    worst, worst_share, main = 0.0, 0.0, None
    for label, *shape in cases:
        args = _ssd_case(gen, *shape)
        got = ssd_scan.ssd_chunk_cuda(*args)
        want = ssd_scan.ssd_chunk_ref(*args)
        torch.cuda.synchronize()
        errs = []
        for name, g, w in zip(("y_diag", "S", "g", "exp_acs"), got, want):
            e = (g - w).abs()
            if not bool(torch.isfinite(g).all()) or not bool(
                    (e <= SSD_ATOL + SSD_RTOL * w.abs()).all()):
                raise AssertionError(f"ssd_chunk {label} {name}: max err "
                                     f"{e.max().item():.3e}")
            errs.append(e.max().item())
            worst_share = max(worst_share, (e / (SSD_ATOL + SSD_RTOL
                                                 * w.abs())).max().item())
        worst = max(worst, max(errs))
        nbytes, flops = ssd_bound(*shape)
        b, nc, q, h, p, n = shape
        in_bytes = 4 * (b * nc * q * h * (p + 1) + 2 * b * nc * q * n + h)
        sets = copies(lambda: _ssd_case(gen, *shape), in_bytes)
        ms = timed(ssd_scan.ssd_chunk_cuda, sets, 100)
        dev_ms = device_ms(ssd_scan.ssd_chunk_cuda, sets, r"ssd_chunk_kernel",
                           iters=30)
        g_ms = graph_ms(ssd_scan.ssd_chunk_cuda, sets)
        plain_ms = timed(ssd_scan.ssd_chunk_ref, sets, 10)
        # the path the kernel takes: SSD_TC_PASSES TF32 passes per product
        bound_ms, by = bound(nbytes, SSD_TC_PASSES * flops,
                             TF32_TC_FLOP_PER_S)
        f32_ms, _ = bound(nbytes, flops)
        log(f"  ssd_chunk {label}: b={b} nc={nc} Q={q} H={h} P={p} N={n} f32"
            f"  max_abs_err y {errs[0]:.2e} S {errs[1]:.2e} g {errs[2]:.2e} "
            f"exp_acs {errs[3]:.2e} (tol {SSD_ATOL:g} + {SSD_RTOL:g}*|ref|;"
            f" worst so far {worst_share:.2f} of it)"
            f"  {ms * 1e3:.1f} us (device {dev_ms * 1e3:.1f} us, graph "
            f"{g_ms * 1e3:.1f} us)  plain {plain_ms * 1e3:.1f} us  bound "
            f"{bound_ms * 1e3:.2f} us ({by}: {nbytes / 1e6:.1f} MB, "
            f"{SSD_TC_PASSES} x {flops / 1e9:.3f} GFLOP on TF32 tensor cores;"
            f" float32 FMA bound {f32_ms * 1e3:.2f} us)  library: no single "
            "call")
        if main is None:
            main = {"name": "ssd_chunk", "route": "cuda",
                    "source": "src/repro_torch/csrc/ssd_scan.cu",
                    "replaces": "src/repro/kernels/ssd_scan.py:57",
                    "shape": (f"{label}: x ({b},{nc},{q},{h},{p}), B/C "
                              f"({b},{nc},{q},{n}) f32"),
                    "ms": ms, "device_ms": dev_ms, "graph_ms": g_ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": by, "library_ms": None}
    x, dt, A, B, C = _ssd_case(gen, 4, 4, 128, 32, 64, 128, live=77)
    y, S, g, eacs = ssd_scan.ssd_chunk_cuda(x, dt, A, B, C)
    x2 = x.clone()
    x2[:, :, 77:] = 1e4
    _, S2, g2, _ = ssd_scan.ssd_chunk_cuda(x2, dt, A, B, C)
    torch.cuda.synchronize()
    if not (torch.equal(S2, S) and torch.equal(g2, g)
            and torch.equal(g, eacs[:, :, 76])
            and bool(torch.isfinite(y).all())):
        raise AssertionError("ssd_chunk: a dt = 0 tail is not an exact no-op")
    log("  ssd_chunk padded tail (dt = 0 past position 77 of 128): S and g "
        "bit-identical whatever x holds there, g == exp(a_cs) at the length")
    main["max_abs_err"] = worst
    main["max_err_share_of_tol"] = worst_share
    return main


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def check_small_reference(arch=ARCH, kv_dtype=None):
    """The port on the card against the port on the CPU (plain kernel
    versions), ``arch`` reduced, prefill + 8 teacher-forced decode steps:
    logits allclose and every decisive greedy token equal.

    The MoE family runs twice.  Over float32 caches the logits are held
    as above.  Over bf16 caches only the decisive tokens are, and the
    logit error is reported: routing is discontinuous, and a K/V value
    rounded to the other bf16 neighbour moves a hidden state by ~1e-3,
    enough to move a token to another expert where the router's k-th and
    (k+1)-th probabilities lie closer (reduced arctic-480b: 6.6e-5 in
    layer 1)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model_zoo
    from repro_torch.parity import greedy_agreement
    cfg = ARCHS[arch].reduced()
    if cfg.family == "moe" and kv_dtype is None:
        check_small_reference(arch, torch.float32)
        kv_dtype = torch.bfloat16
    params = model_zoo.init_params(torch.Generator().manual_seed(1), cfg)
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 24)))
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 8)))
    logs = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        cache = model_zoo.init_cache(cfg, 4, 64, kv_dtype or torch.bfloat16,
                                     device=dev)
        out, cache = model_zoo.prefill(p, cfg, prompt.to(dev), cache)
        steps = [out.cpu().numpy()]
        for i in range(feed.shape[1]):
            out, cache = model_zoo.decode_step(p, cfg, feed[:, i:i + 1].to(dev),
                                               cache)
            steps.append(out.cpu().numpy())
        logs[dev] = np.stack(steps)
    err = float(np.abs(logs["cuda"] - logs["cpu"]).max())
    n, agree = greedy_agreement(logs["cpu"], logs["cuda"], SMALL_LOGIT_TOL)
    held = not (cfg.family == "moe" and kv_dtype == torch.bfloat16)
    kind = "" if kv_dtype is None else f", {str(kv_dtype)[6:]} cache"
    log(f"  small input (reduced {arch}{kind}, card vs CPU, 9 steps): max "
        f"logit err {err:.2e} "
        f"({f'tol {SMALL_LOGIT_TOL:g}' if held else 'reported'}); decisive "
        f"tokens {agree}/{n}")
    if (held and not err <= SMALL_LOGIT_TOL) or n == 0 or agree != n:
        raise AssertionError("card and CPU disagree on the small input")


def check_small_int8_reference(arch=ARCH):
    """``parity.paged_trace`` over reduced ``arch``'s int8 pool on the card
    (the int8 kernel bodies, the in-place write side on CUDA tensors)
    against the CPU (plain versions), same params: a prefill, a COW of a
    part-filled page, decode steps, and a chunk that writes one page up to
    six times and crosses into the next.  ``parity.traces_close``: logits
    within the family's ``TRACE_LOGIT_TOL``, levels within 1 (at most 1 in
    200 off by 1), scale rows within rtol 5e-3.  The CPU's int8-vs-bf16
    logit gap on the same trace must exceed the logit limit, so that a card
    that attended over unquantised K/V would fail."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo
    from repro_torch.parity import TRACE_LOGIT_TOL, paged_trace, traces_close
    cfg = ARCHS[arch].reduced()
    params = model_zoo.init_params(torch.Generator().manual_seed(2), cfg)
    cpu = paged_trace(params, cfg, torch.int8)
    gap = max(float(np.abs(a - b).max()) for a, b in
              zip(cpu[0], paged_trace(params, cfg, torch.bfloat16)[0]))
    before = ops.launch_counts()
    card = paged_trace(_to(params, "cuda"), cfg, torch.int8, "cuda")
    ran = {k: v - before[k] for k, v in ops.launch_counts().items()
           if k.endswith("[int8]") and v > before[k]}
    tol = TRACE_LOGIT_TOL[arch]
    err, flips, rel = traces_close(card, cpu, tol)
    log(f"  small int8 trace (reduced {arch}, card vs CPU): max logit err "
        f"{err:.2e} (limit {tol:g}; the CPU's int8-vs-bf16 gap {gap:.2e}); "
        f"levels off by 1: {flips}; max scale rel err {rel:.2e}; "
        f"launches {ran}")
    want = {"decode_attention_paged[int8]", "copy_pages[int8]"}
    if cfg.family in ATTENTION_FAMILIES:
        want.add("decode_attention_chunk_paged[int8]")
    if not gap > tol or set(ran) != want:
        raise AssertionError("the int8 trace check cannot tell int8 from "
                             "bf16, or missed a kernel")


def _to(tree, dev):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def _drain_expected(eng):
    """Each kernel's launches per serve: hi_gate gates both tiers' T steps;
    the attention families' (dense, MoE) decode attention runs once per
    layer and step; the MoE family's routed FFN (route_pairs, then
    grouped_swiglu) once per layer and pass, the prefill and T steps; the
    SSM family's prefill launches ssd_chunk once per layer and tier."""
    exp = dict.fromkeys(_kernel_names(), 0)
    exp["hi_gate"] = 2 * MAX_NEW
    for cfg in (eng.s.cfg, eng.l.cfg):
        if cfg.family == "moe":
            for name in ("grouped_swiglu", "route_pairs"):
                exp[name] += (1 + MAX_NEW) * cfg.num_layers
        if cfg.family in ATTENTION_FAMILIES:
            exp["decode_attention"] += MAX_NEW * cfg.num_layers
        else:
            exp["ssd_chunk"] += cfg.num_layers
    return exp


def _kernel_names():
    from repro_torch.kernels import ops
    return tuple(ops.KERNELS)


def serve_full_width(arch=ARCH):
    import numpy as np
    import torch
    from repro_torch.configs.base import HIConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.batcher import Batcher, Request

    cfg = ARCHS[arch]
    hi = HIConfig(theta=THETA, capacity_factor=CAPACITY)
    t0 = time.perf_counter()
    eng = engine_mod.build_engine(cfg, hi, seed=0, cache_len=CACHE_LEN,
                                  max_new_tokens=MAX_NEW, device="cuda")
    torch.cuda.synchronize()
    n_params = {t: sum(v.numel() for v in _leaves(tier.params))
                for t, tier in (("L", eng.l), ("S", eng.s))}
    log(f"  built {cfg.name} L ({n_params['L'] / 1e9:.3f} B params, "
        f"{eng.l.cfg.num_layers} layers) + S {eng.s.cfg.name} "
        f"({n_params['S'] / 1e9:.3f} B, {eng.s.cfg.num_layers} layers) in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    batcher = Batcher(batch_size=BATCH, buckets=BUCKETS)
    for i in range(N_REQUESTS):
        plen = int(rng.integers(32, 513))
        batcher.submit(Request(i, rng.integers(1, cfg.vocab_size, plen)
                               .astype(np.int32), max_new_tokens=MAX_NEW))

    fetches = []
    real_fetch = engine_mod._host_fetch

    def counting_fetch(tree):
        fetches.append(1)
        return real_fetch(tree)

    engine_mod._host_fetch = counting_fetch
    want = _drain_expected(eng)
    log(f"  expected launches per serve (hi_gate = 2*T; decode_attention = "
        f"T*(L_S + L_L) for the dense family; ssd_chunk = L_S + L_L for the "
        f"SSM family, T = {MAX_NEW}, L_S = {eng.s.cfg.num_layers}, L_L = "
        f"{eng.l.cfg.num_layers}): {want}")
    torch.cuda.reset_peak_memory_stats()
    served = gen_tokens = 0
    t_serve = 0.0
    try:
        ops.reset_launch_counts()
        while batcher.queue:
            batch = batcher.next_batch()
            before = ops.launch_counts()
            n_fetch = len(fetches)
            t0 = time.perf_counter()
            out = eng.serve(batch.tokens)
            dt = time.perf_counter() - t0
            t_serve += dt
            after = ops.launch_counts()
            if len(fetches) - n_fetch != 1:
                raise AssertionError(f"serve made {len(fetches) - n_fetch} "
                                     "host fetches, expected 1")
            got = {k: after[k] - before[k] for k in after}
            if got != want:
                raise AssertionError(f"launches per serve {got}, want {want}")
            _check_outputs(out, batch, cfg, THETA)
            live = batch.request_ids >= 0
            served += int(live.sum())
            gen_tokens += int(live.sum()) * MAX_NEW
            log(f"  serve batch bucket={batch.bucket}: {dt * 1e3:.1f} ms, "
                f"offloaded {int(out['offloaded'].sum())}/{BATCH}, served "
                f"remote {int(out['served_remote'].sum())}, mean conf "
                f"{float(out['confidence'].mean()):.4f}")
        summary = eng.summary()
        # Random-init confidences all sit far below THETA, so every row
        # offloads.  Serve the last batch once more with theta between the
        # 4th and 5th smallest of its confidences, so that the rule keeps
        # rows local for their confidence too, not only for lack of room.
        conf = np.sort(out["confidence"])
        theta = float(np.float32((conf[BATCH // 2 - 1] + conf[BATCH // 2]) / 2))
        eng.hi = dataclasses.replace(eng.hi, theta=theta)
        before, n_fetch = ops.launch_counts(), len(fetches)
        out = eng.serve(batch.tokens)
        after = ops.launch_counts()
        got = {k: after[k] - before[k] for k in after}
        if got != want or len(fetches) - n_fetch != 1:
            raise AssertionError(f"launches per serve {got}, host fetches "
                                 f"{len(fetches) - n_fetch}")
        _check_outputs(out, batch, cfg, theta)
        n_off = int(out["offloaded"].sum())
        if n_off != BATCH // 2 or int(out["served_remote"].sum()) != n_off:
            raise AssertionError(f"theta {theta:.6f}: offloaded {n_off}, "
                                 f"served remote "
                                 f"{int(out['served_remote'].sum())}; "
                                 f"expected {BATCH // 2} and {BATCH // 2}")
        log(f"  serve again at theta {theta:.6f} (median confidence): "
            f"offloaded {n_off}/{BATCH}, all served remote, "
            f"{BATCH - n_off} kept local on confidence")
        eng.hi = dataclasses.replace(eng.hi, theta=THETA)
        launches = ops.launch_counts()
    finally:
        engine_mod._host_fetch = real_fetch
    peak = torch.cuda.max_memory_allocated()
    s = summary
    log(f"  served {served} requests in {t_serve:.3f} s: "
        f"{served / t_serve:.2f} req/s, {gen_tokens / t_serve:.1f} generated "
        f"tok/s; offload_frac {s['offload_frac']:.3f} drop_frac "
        f"{s['drop_frac']:.3f}; cache_allocs {s['cache_allocs']}; peak "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; host fetches "
        f"{len(fetches)}; launches {launches}")
    return launches, eng, batch.tokens


# ---------------------------------------------------------------------------
# phase 5: the continuous path
# ---------------------------------------------------------------------------

def check_small_stream_reference(arch=ARCH):
    """Reduced ``arch`` ``serve_stream`` (prefix sharing with COW, the
    chunk lane) on the card against the CPU (plain versions), same params:
    equal statuses, and S tokens equal up to the CPU's first position whose
    top1 - top2 logit margin is under ``2 * SMALL_LOGIT_TOL``
    (teacher-forced on the CPU's contiguous path)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import HIConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model_zoo
    from repro_torch.parity import decisive
    from repro_torch.serving.batcher import Request, pad_to_bucket
    from repro_torch.serving.engine import HIEngine, TierModel
    cfg = ARCHS[arch].reduced()
    g = torch.Generator().manual_seed(2)
    cpu = [TierModel(c, model_zoo.init_params(g, c))
           for c in (cfg.s_variant(4), cfg)]
    gpu = [TierModel(t.cfg, _to(t.params, "cuda")) for t in cpu]
    rng = np.random.default_rng(2)
    # repeats of a 14-token prefix land in the 20 bucket (a partial tail
    # page of 8: restores copy it) and take the admit lane (chunk_size 20);
    # the 48-bucket prompts take the chunk lane
    base = rng.integers(1, cfg.vocab_size, 14).astype(np.int32)
    reqs = []
    for i in range(10):
        p = (np.concatenate([base, np.full(4 + i % 2, 7, np.int32)])
             if i % 3 == 0 else
             rng.integers(1, cfg.vocab_size, int(rng.integers(4, 48)))
             .astype(np.int32))
        reqs.append(Request(i, p, max_new_tokens=6))
    kw = dict(buckets=(8, 20, 48), num_slots=4, l_slots=2, page_size=8,
              decode_block=2, chunk_prefill=True, chunk_size=20,
              validate=True)
    outs = {}
    for dev, tiers in (("cpu", cpu), ("cuda", gpu)):
        eng = HIEngine(*tiers, HIConfig(theta=0.02, capacity_factor=1.0),
                       max_new_tokens=6)
        outs[dev] = eng.serve_stream(reqs, **kw)
    n_cmp = n_tok = 0
    for r in reqs:
        c, k = outs["cpu"][r.request_id], outs["cuda"][r.request_id]
        if c["status"] != k["status"]:
            raise AssertionError(f"request {r.request_id}: status "
                                 f"{k['status']} on the card, {c['status']} "
                                 "on the CPU")
        prompt = np.zeros(pad_to_bucket(len(r.prompt), kw["buckets"]),
                          np.int64)
        prompt[: len(r.prompt)] = r.prompt
        cache = model_zoo.init_cache(cfg.s_variant(4), 1, 64, device="cpu")
        lg, cache = model_zoo.prefill(cpu[0].params, cpu[0].cfg,
                                      torch.from_numpy(prompt[None]), cache)
        logs = [lg[0].numpy()]
        for t in c["s_tokens"][:-1]:
            lg, cache = model_zoo.decode_step(cpu[0].params, cpu[0].cfg,
                                              torch.tensor([[int(t)]]), cache)
            logs.append(lg[0].numpy())
        dec = decisive(np.stack(logs), 2 * SMALL_LOGIT_TOL)
        first = int(np.argmin(dec)) if not dec.all() else len(dec)
        if not np.array_equal(k["s_tokens"][:first], c["s_tokens"][:first]):
            raise AssertionError(f"request {r.request_id}: card S tokens "
                                 f"{k['s_tokens']} != CPU {c['s_tokens']}")
        n_cmp += first
        n_tok += len(c["s_tokens"])
    log(f"  small stream (reduced {arch}, card vs CPU, {len(reqs)} requests):"
        f" statuses equal; {n_cmp}/{n_tok} S tokens compared (up to the "
        f"first margin under {2 * SMALL_LOGIT_TOL:g}), all equal")
    if n_cmp == 0:
        raise AssertionError("no decisive token to compare")


def _stream_trace(cfg, seed=0):
    """32 requests in a seeded order: 12 ``mixed_poisson``-style (prompts of
    32..512, 4..16 new tokens), 12 ``repeated_prefix``-style (a 224-token
    system prompt + one of four tails of 8..24 tokens, so repeats restore
    from the prefix cache and, in the 248 bucket, copy-on-write), and 8
    ``long_prompt``-style (384..512, which the chunk lane ingests)."""
    import numpy as np
    from repro_torch.serving.batcher import Request
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    prompts = [(rng.integers(1, v, int(rng.integers(32, 513))),
                int(rng.integers(4, 17))) for _ in range(N_MIXED)]
    sys_prompt = rng.integers(1, v, SYS_PREFIX)
    tails = [rng.integers(1, v, n) for n in (8, 12, 20, 24)]
    prompts += [(np.concatenate([sys_prompt, tails[i % 4]]), MAX_NEW)
                for i in range(N_REPEAT)]
    prompts += [(rng.integers(1, v, int(rng.integers(384, 513))), MAX_NEW)
                for _ in range(N_LONG)]
    order = rng.permutation(len(prompts))
    return [Request(i, prompts[j][0].astype(np.int32),
                    max_new_tokens=prompts[j][1])
            for i, j in enumerate(order)]


def _expected_launches(sched, before, kb, chunk):
    """Each kernel's launches over a run, from the ticks in which the host
    ran each lane on each tier (``lane_ticks`` at the run's end less
    ``before``).  Dense and MoE: the paged kernels once per layer and decode
    step or chunk pass, copy_pages once per COW tick.  SSM: ssd_chunk once per layer
    and prefill, no pages.  Hybrid: ssd_chunk once per mamba layer and
    prefill, the paged decode kernel once per group and step (the chunk
    lane's ``chunk`` per-token steps included), copy_pages per COW tick.
    Speculative: the L tier's ``live`` ticks are verify ticks, which gate
    nothing and run one ``kb``-token chunk pass (dense: the chunk kernel
    once per layer; the hybrid's ``kb`` per-token steps as its decode).
    MoE: its routed FFN (route_pairs, then grouped_swiglu) once per layer
    and pass: the admission prefill, each chunk pass and decode step, and
    each verify pass."""
    exp = dict.fromkeys(_kernel_names(), 0)
    for rt in (sched.local_srt, sched.lrt):
        d = {k: rt.lane_ticks[k] - before[rt.name][k] for k in rt.lane_ticks}
        cfg = rt.pool.cfg
        n_layers = cfg.num_layers
        verify = sched.speculative and rt is sched.lrt
        # over int8 pools the paged kernels count as their int8 variants
        q = "[int8]" if rt.pool.kv_dtype == "int8" else ""
        exp["hi_gate"] += d["admit"] + d["chunk"] + \
            (0 if verify else kb * d["live"])
        if cfg.family == "moe":
            for name in ("grouped_swiglu", "route_pairs"):
                exp[name] += n_layers * (d["prefill"] + d["chunk"]
                                         + (1 if verify else kb) * d["live"])
        if cfg.family in ATTENTION_FAMILIES:
            if verify:
                exp["decode_attention_chunk_paged" + q] += \
                    n_layers * d["live"]
            else:
                exp["decode_attention_paged" + q] += \
                    kb * n_layers * d["live"]
            exp["decode_attention_chunk_paged" + q] += n_layers * d["chunk"]
            exp["copy_pages" + q] += d["cow"]
            continue
        exp["ssd_chunk"] += n_layers * d["prefill"]
        if cfg.family == "hybrid":
            g = n_layers // cfg.shared_attn_every
            exp["decode_attention_paged" + q] += g * (kb * d["live"]
                                                      + chunk * d["chunk"])
            exp["copy_pages" + q] += d["cow"]
    return exp


def _graphs(sched) -> str:
    """The scheduler's decode-lane CUDA graphs so far, per tier: captures
    and replays (``serving/lane_graphs.py``)."""
    st = sched.stats
    return (f"graph captures {st['graph_captures']}, replays "
            f"{st['graph_replays']}, eager ticks {st['graph_eager_ticks']}")


def serve_stream_full_width(eng, kw=STREAM_KW, reqs=None,
                            need=("cow", "saved", "chunk")):
    """The continuous path at full width, two runs (theta 0.6, then the
    median S confidence of the first); ``need`` names the lanes that must
    have worked: "cow" (copy-on-write copies), "saved" (prefill tokens
    saved by the prefix cache), "restore" (whole-prompt restores), "chunk"
    (chunk-lane ticks).  Returns the launches of the two runs (counts set
    to 0 just before the first, read after the second), the trace and the
    first run's records."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.faults import STATUSES

    reqs = _stream_trace(eng.l.cfg) if reqs is None else reqs
    lens = sorted(len(r.prompt) for r in reqs)
    log(f"  trace: {len(reqs)} requests, prompt lengths {lens[0]}..{lens[-1]}"
        f" (median {lens[len(lens) // 2]}); settings {kw}")
    fetches = []
    real_fetch = engine_mod._host_fetch

    def counting_fetch(tree):
        fetches.append(1)
        return real_fetch(tree)

    engine_mod._host_fetch = counting_fetch
    torch.cuda.reset_peak_memory_stats()
    kb = kw["decode_block"]
    chunk = kw["chunk_size"] if kw.get("chunk_prefill") else 0
    total = {}
    theta = THETA
    cow0 = saved0 = full0 = chunk_ticks = 0
    worked = dict.fromkeys(("cow", "saved", "restore"), 0)
    try:
        ops.reset_launch_counts()
        for run in range(2):
            eng.hi = dataclasses.replace(eng.hi, theta=theta)
            prev = eng._stream[1] if eng._stream else None
            lanes0 = ({rt.name: dict(rt.lane_ticks)
                       for rt in (prev.srt, prev.lrt)} if prev else None)
            counts0, ticks0 = ops.launch_counts(), eng.stats["stream_ticks"]
            n_fetch = len(fetches)
            if prev:
                cow0 = prev.prefix_stats["cow_copies"]
                full0 = prev.prefix_stats["full_hits"]
            saved0 = eng.stats["prefill_tokens_saved"]
            t0 = time.perf_counter()
            out = eng.serve_stream(reqs, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            sched = eng._stream[1]
            if sched is not prev:         # a new scheduler (other settings)
                lanes0 = {rt.name: dict.fromkeys(rt.lane_ticks, 0)
                          for rt in (sched.srt, sched.lrt)}
                cow0 = full0 = 0
            ticks = eng.stats["stream_ticks"] - ticks0
            counts = {k: v - counts0[k] for k, v in ops.launch_counts().items()}
            want = _expected_launches(sched, lanes0, kb, chunk)
            if len(fetches) - n_fetch != ticks or ticks == 0:
                raise AssertionError(f"{len(fetches) - n_fetch} host fetches "
                                     f"in {ticks} ticks")
            if counts != want:
                raise AssertionError(f"launches {counts}, lane flags predict "
                                     f"{want}")
            if set(out) != {r.request_id for r in reqs}:
                raise AssertionError("not one record per request")
            if sched.srt.pool.held_slots or sched.lrt.pool.held_slots:
                raise AssertionError("slots held after drain")
            _check_stream_outputs(out, reqs, eng.l.cfg, theta, STATUSES)
            cow = sched.prefix_stats["cow_copies"] - cow0
            full = sched.prefix_stats["full_hits"] - full0
            saved = eng.stats["prefill_tokens_saved"] - saved0
            chunk_ticks += sum(want_l for want_l in (
                sched.srt.lane_ticks["chunk"] - lanes0["S"]["chunk"],
                sched.lrt.lane_ticks["chunk"] - lanes0["L"]["chunk"]))
            n_req = len(out)
            n_off = sum(r["offloaded"] for r in out.values())
            n_drop = sum(r["dropped"] for r in out.values())
            n_tok = sum(len(r["tokens"]) for r in out.values())
            log(f"  serve_stream at theta {theta:.6f}: {wall * 1e3:.1f} ms, "
                f"{ticks} ticks ({ticks / wall:.2f} ticks/s), {n_req / wall:.2f}"
                f" req/s, {n_tok / wall:.1f} generated tok/s ({n_tok} tokens)"
                f"; offload_frac {n_off / n_req:.3f} drop_frac "
                f"{n_drop / n_req:.3f}; served remote "
                f"{sum(r['served_remote'] for r in out.values())}; "
                f"prefill_tokens_saved {saved}, full restores {full}, "
                f"cow_copies {cow}; one host "
                f"fetch per tick; launches {counts} as the lane flags "
                f"predict; {_graphs(sched)}")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            if run == 1 and not 0 < n_off < n_req:
                raise AssertionError(f"theta {theta:.6f}: {n_off} of {n_req} "
                                     "offloaded; both branches must run")
            # the second run: theta at the median S confidence of the first
            theta = float(np.float32(np.median(
                [r["confidence"] for r in out.values()])))
            if run == 0:
                first_cow, first_saved, first_out = cow, saved, out
            worked["cow"] += cow
            worked["saved"] += saved
            worked["restore"] += full
        worked["chunk"] = chunk_ticks
        if not all(worked[k] > 0 for k in need):
            raise AssertionError(f"{worked}: a lane of {need} never ran")
    finally:
        engine_mod._host_fetch = real_fetch
        eng.hi = dataclasses.replace(eng.hi, theta=THETA)
    peak = torch.cuda.max_memory_allocated()
    pools = sum(rt.pool.kv_bytes_total for rt in (sched.srt, sched.lrt))
    log(f"  stream totals: cow_copies {worked['cow']} (first run "
        f"{first_cow}), prefill_tokens_saved {worked['saved']} (first run "
        f"{first_saved}), chunk ticks {chunk_ticks}; pool buffers (pages, "
        f"scale and state rows) "
        f"{pools / 2 ** 30:.2f} GiB; peak max_memory_allocated "
        f"{peak / 2 ** 30:.2f} GiB; stream_compiles "
        f"{eng.stats['stream_compiles']}")
    return total, reqs, first_out


# ---------------------------------------------------------------------------
# phases 6-8: the recurrent families
# ---------------------------------------------------------------------------

def chunk_lane_phase():
    """The chunk lane at mamba2 widths, cut to 8 layers (S: 2): four prompts
    of 96..200 tokens fed 64 per tick through the per-token recurrent lane,
    with its staged rollback (rows committed after exactly ``chunk_keep``
    inputs, slots mid-prefill restored after the decode lane).  Launches
    against the lane flags, one fetch per tick; then each request's S tokens
    against the same per-token steps run on a one-row contiguous cache from
    a zero state (what the lane must compute, without its staging and
    rollback), teacher-forced, up to the first margin under
    ``2 * CHUNK_LOGIT_TOL``.  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.configs.base import HIConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo
    from repro_torch.parity import decisive
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.batcher import Request, pad_to_bucket
    from repro_torch.serving.faults import STATUSES

    cfg = dataclasses.replace(ARCHS[SSM_ARCH], num_layers=CHUNK_DEPTH)
    eng = engine_mod.build_engine(
        cfg, HIConfig(theta=THETA, capacity_factor=CAPACITY), seed=0,
        cache_len=CACHE_LEN, max_new_tokens=MAX_NEW, device="cuda")
    rng = np.random.default_rng(5)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, int(n))
                    .astype(np.int32), max_new_tokens=MAX_NEW)
            for i, n in enumerate(rng.integers(96, 201, 4))]
    fetches = []
    real_fetch = engine_mod._host_fetch
    engine_mod._host_fetch = lambda tree: (fetches.append(1),
                                           real_fetch(tree))[1]
    torch.cuda.reset_peak_memory_stats()
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = eng.serve_stream(reqs, **CHUNK_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        engine_mod._host_fetch = real_fetch
    sched = eng._stream[1]
    zero = {rt.name: dict.fromkeys(rt.lane_ticks, 0)
            for rt in (sched.srt, sched.lrt)}
    want = _expected_launches(sched, zero, CHUNK_KW["decode_block"],
                              CHUNK_KW["chunk_size"])
    ticks = eng.stats["stream_ticks"]
    chunk_ticks = sched.srt.lane_ticks["chunk"] + sched.lrt.lane_ticks["chunk"]
    if counts != want or len(fetches) != ticks or chunk_ticks == 0:
        raise AssertionError(f"launches {counts} (lane flags predict {want}),"
                             f" {len(fetches)} fetches in {ticks} ticks, "
                             f"{chunk_ticks} chunk ticks")
    if sched.srt.pool.held_slots or sched.lrt.pool.held_slots:
        raise AssertionError("slots held after drain")
    _check_stream_outputs(out, reqs, cfg, THETA, STATUSES)
    n_cmp = n_tok = 0
    tier = eng.s
    for r in reqs:
        rec = out[r.request_id]
        prompt = np.zeros(pad_to_bucket(len(r.prompt), CHUNK_KW["buckets"]),
                          np.int64)
        prompt[: len(r.prompt)] = r.prompt
        cache = model_zoo.init_cache(tier.cfg, 1, CACHE_LEN)
        feed = torch.as_tensor(prompt[:, None], device="cuda")
        for t in feed:
            lg, cache = model_zoo.decode_step(tier.params, tier.cfg, t[None],
                                              cache)
        logs = [lg[0]]
        for t in rec["s_tokens"][:-1]:
            lg, cache = model_zoo.decode_step(
                tier.params, tier.cfg,
                torch.tensor([[int(t)]], device="cuda"), cache)
            logs.append(lg[0])
        logs = torch.stack(logs).cpu().numpy()
        dec = decisive(logs, 2 * CHUNK_LOGIT_TOL)
        first = int(np.argmin(dec)) if not dec.all() else len(dec)
        if not np.array_equal(rec["s_tokens"][:first],
                              logs.argmax(-1)[:first]):
            raise AssertionError(f"request {r.request_id}: chunk-lane S "
                                 f"tokens {rec['s_tokens']} != the per-token"
                                 f" path's {logs.argmax(-1)}")
        n_cmp += first
        n_tok += len(rec["s_tokens"])
    if n_cmp == 0:
        raise AssertionError("no decisive token to compare")
    log(f"  chunk lane ({cfg.name} at {CHUNK_DEPTH} layers, S "
        f"{eng.s.cfg.num_layers}; {len(reqs)} prompts of "
        f"{sorted(len(r.prompt) for r in reqs)} tokens; {CHUNK_KW}): "
        f"{wall * 1e3:.1f} ms, {ticks} ticks of which {chunk_ticks} ran the "
        f"chunk lane (S {sched.srt.lane_ticks['chunk']}, L "
        f"{sched.lrt.lane_ticks['chunk']}); {_graphs(sched)}; launches "
        f"{counts} as the lane "
        f"flags predict; {n_cmp}/{n_tok} S tokens equal to the per-token "
        f"path's (up to the first margin under {2 * CHUNK_LOGIT_TOL:g}); "
        f"peak max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return counts


def _hybrid_trace(cfg, seed=0):
    """12 requests: 6 take the 224-token system prompt with one of two
    tails (232 and 248 tokens, both in the 248 bucket, whose partial tail
    page restores copy), 6 mixed prompts of 32..256 tokens."""
    import numpy as np
    from repro_torch.serving.batcher import Request
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    sys_prompt = rng.integers(1, v, SYS_PREFIX)
    tails = [rng.integers(1, v, n) for n in (8, 24)]
    prompts = [(np.concatenate([sys_prompt, tails[i % 2]]), MAX_NEW)
               for i in range(6)]
    prompts += [(rng.integers(1, v, int(rng.integers(32, 257))),
                 int(rng.integers(4, 17))) for _ in range(6)]
    order = rng.permutation(len(prompts))
    return [Request(i, prompts[j][0].astype(np.int32),
                    max_new_tokens=prompts[j][1])
            for i, j in enumerate(order)]


def hybrid_stream_phase():
    """zamba2-2.7b at full width, cut to 24 layers (S: 6): the reference
    cannot build the full-depth cascade.  ``serve_stream`` with sharing on
    and chunking off at theta 0.6 and at the median: ssd_chunk on every
    prefill, the paged decode kernel at head dim 80, copy_pages on the
    restores of the 248 bucket; then the same with int8 pools
    (:func:`int8_stream_phase`).  Returns the launches of both."""
    import torch
    from repro_torch.configs.base import HIConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.serving import engine as engine_mod
    cfg = dataclasses.replace(ARCHS[HYBRID_ARCH], num_layers=HYBRID_DEPTH)
    t0 = time.perf_counter()
    eng = engine_mod.build_engine(
        cfg, HIConfig(theta=THETA, capacity_factor=CAPACITY), seed=0,
        cache_len=CACHE_LEN, max_new_tokens=MAX_NEW, device="cuda")
    torch.cuda.synchronize()
    n_params = {t: sum(v.numel() for v in _leaves(tier.params))
                for t, tier in (("L", eng.l), ("S", eng.s))}
    log(f"  built {cfg.name} at {HYBRID_DEPTH} layers: L "
        f"({n_params['L'] / 1e9:.3f} B params, head dim "
        f"{cfg.resolved_head_dim}, {cfg.num_layers // cfg.shared_attn_every}"
        f" groups) + S ({n_params['S'] / 1e9:.3f} B, "
        f"{eng.s.cfg.num_layers} layers) in {time.perf_counter() - t0:.1f} s")
    reqs = _hybrid_trace(cfg)
    need = ("cow", "saved", "restore")
    launches, _, out = serve_stream_full_width(eng, HYBRID_KW, reqs,
                                               need=need)
    log(f"== serve_stream ({HYBRID_ARCH}, int8 pools)")
    launches8 = int8_stream_phase(eng, HYBRID_KW, reqs, out, need)
    return launches, launches8


# ---------------------------------------------------------------------------
# int8 paged pools
# ---------------------------------------------------------------------------

def int8_stream_phase(eng, kw, reqs, bf16_out, need, max_ratio=None):
    """``serve_stream`` on the same engine and trace with
    ``kv_dtype="int8"``, right after the bf16 run whose scheduler is still
    ``eng._stream``: launches of the int8 bodies against the lane flags, one
    fetch per tick and the rest of :func:`serve_stream_full_width`; then the
    pool bytes against bf16's (at most ``max_ratio`` when given, else
    reported), the slots the bf16 byte budget admits in int8, the free-run
    token agreement with the bf16 run at theta 0.6, and the reference's
    teacher-forced measure on the L tier's params (reported: random-init
    margins sit near ties at full width), and the L tier's decode step time
    over both pool dtypes.  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.parity import int8_agreement
    sched = eng._stream[1]
    g16 = {rt.name: rt.pool.gauges() for rt in (sched.srt, sched.lrt)}
    n_slots = {rt.name: rt.num_slots for rt in (sched.srt, sched.lrt)}
    launches, _, out8 = serve_stream_full_width(
        eng, dict(kw, kv_dtype="int8"), reqs, need=need)
    sched = eng._stream[1]
    g8 = {rt.name: rt.pool.gauges() for rt in (sched.srt, sched.lrt)}
    if any(g["kv_bits"] != 8 for g in g8.values()):
        raise AssertionError(f"int8 pools report {g8}")
    b16 = sum(g["kv_bytes_total"] for g in g16.values())
    b8 = sum(g["kv_bytes_total"] for g in g8.values())
    ratio = b8 / b16
    if max_ratio is not None and not ratio <= max_ratio:
        raise AssertionError(f"int8 pools are {ratio:.4f}x the bf16 pools' "
                             f"bytes (limit {max_ratio})")
    at_budget = {t: n_slots[t] * g16[t]["bytes_per_slot"]
                 // g8[t]["bytes_per_slot"] for t in g8}
    same = [np.mean(np.asarray(bf16_out[r]["tokens"])
                    == np.asarray(out8[r]["tokens"]))
            for r in bf16_out
            if len(bf16_out[r]["tokens"]) == len(out8[r]["tokens"])]
    match, total, err = int8_agreement(eng.l.params, eng.l.cfg, "cuda")
    step = {dt: _decode_step_ms(eng.l, dt)
            for dt in (torch.bfloat16, torch.int8)}
    log(f"  int8 vs bf16 ({eng.l.cfg.name}, {eng.l.cfg.num_layers} layers): "
        f"pool bytes {b8} / {b16} = {ratio:.4f}"
        f"{f' (limit {max_ratio})' if max_ratio else ' (reported: the recurrent state does not shrink)'}"
        f"; slots the bf16 budget admits in int8: S {at_budget['S']} (bf16 "
        f"{n_slots['S']}), L {at_budget['L']} (bf16 {n_slots['L']}); "
        f"free-run token agreement at theta {THETA} {np.mean(same):.4f} over "
        f"{len(same)} requests; L-tier decode step (8 slots) "
        f"{step[torch.int8]:.2f} ms over int8 pools, "
        f"{step[torch.bfloat16]:.2f} ms over bf16; teacher-forced agreement "
        f"on the L tier "
        f"(8 slots, 16 steps, page 8) {match}/{total} = {match / total:.4f},"
        f" max logit diff {err:.4f} (reported)")
    return launches


def _decode_step_ms(tier, dtype):
    """Host wall per ``decode_step_paged`` of ``tier`` (synchronised, after
    two warm-up steps) over a fresh pool of ``dtype`` with pages of 16: 8
    prompts of 16 tokens prefilled, then 16 greedy steps."""
    import torch
    from repro_torch.models import model_zoo
    cfg = tier.cfg
    slots, prompt, steps, page = 8, 16, 16, 16
    npg = (prompt + steps + 2) // page + 1
    block = torch.arange(1, slots * npg + 1, dtype=torch.int32,
                         device="cuda").reshape(slots, npg)
    cache = model_zoo.init_paged_cache(cfg, slots, slots * npg + 1, page,
                                       dtype, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(1, cfg.vocab_size, (slots, prompt), generator=gen,
                         device="cuda")
    lg, cache = model_zoo.prefill_paged(
        tier.params, cfg, toks, torch.full((slots,), prompt, device="cuda"),
        torch.arange(slots, device="cuda"), block, cache)
    pos = torch.full((slots,), prompt, device="cuda")
    for i in range(steps + 2):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        lg, cache = model_zoo.decode_step_paged(tier.params, cfg,
                                                lg.argmax(-1)[:, None],
                                                pos + i, block, cache)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def int8_gate_phase():
    """The reference's int8 fidelity gate (``benchmarks/bench_serving.py``
    ``_teacher_forced_agreement``, asserted there at >= 0.99 on zamba2) on
    the card with the kernels: reduced zamba2-2.7b, random params from seed
    0 (the port's generator on the card, as ``build_engine``), prompts from
    numpy seed 1, 8 slots, 16 steps, page 8, prompt 16; bf16 against int8
    pools, teacher-forced on the bf16 argmax, 136 decisions.  The same
    params on the CPU (plain versions) are reported beside it."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo
    from repro_torch.parity import int8_agreement
    cfg = ARCHS[HYBRID_ARCH].reduced()
    params = model_zoo.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    before = ops.launch_counts()
    match, total, err = int8_agreement(params, cfg, "cuda")
    torch.cuda.synchronize()
    ran = ops.launch_counts()["decode_attention_paged[int8]"] \
        - before["decode_attention_paged[int8]"]
    cpu = int8_agreement(_to(params, "cpu"), cfg)
    log(f"  int8 gate (reduced {HYBRID_ARCH}, card with the kernels, "
        f"{ran} int8 paged launches): {match}/{total} = {match / total:.4f} "
        f"(limit 0.99), max logit diff {err:.4f}; the same params on the "
        f"CPU: {cpu[0]}/{cpu[1]}")
    if total != 136 or ran == 0 or not match / total >= 0.99:
        raise AssertionError("the int8 fidelity gate failed")


# ---------------------------------------------------------------------------
# faults, observability and the speculative lane (qwen2-1.5b, mamba2)
# ---------------------------------------------------------------------------

def check_verify_chunk(gen):
    """The chunk kernel at the speculative verify lane's shape: q (8, 4,
    12, 128), the L tier's 8 slots paired with the S tier's, over the L
    pool; bf16, then int8 with garbage planted where no query looks.
    Timed as the other paged cases, with a CUDA-graph replay.  Returns the
    two cases' results."""
    import numpy as np
    c = SPEC_KW["decode_block"]
    pos = np.random.default_rng(4).integers(32, 528, 8).tolist()
    case = ("L verify qwen2-1.5b", 8, 12, 2, 128, SPEC_L_PAGES, pos, NPG)
    return (check_paged(gen, "decode_attention_chunk_paged", c,
                        [case + (False,)], graph=True),
            check_paged(gen, "decode_attention_chunk_paged", c,
                        [case + (True,)], quant=True, graph=True))


def _counted_run(eng, reqs, kw, **extra):
    """One ``serve_stream`` call on a fresh scheduler (so that runs do not
    share a prefix cache), the launch counts set to 0 just before it and
    read just after.  Asserts one host fetch per tick, every kernel's
    launches as the lane flags predict, one record per request and no slot
    held after the drain.  Returns (records, scheduler, launches, ticks,
    wall seconds)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import engine as engine_mod

    eng._stream = None
    fetches = []
    real = engine_mod._host_fetch
    engine_mod._host_fetch = lambda tree: (fetches.append(1), real(tree))[1]
    ticks0 = eng.stats["stream_ticks"]
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = eng.serve_stream(reqs, **kw, **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        engine_mod._host_fetch = real
    sched = eng._stream[1]
    ticks = eng.stats["stream_ticks"] - ticks0
    zero = {rt.name: dict.fromkeys(rt.lane_ticks, 0)
            for rt in (sched.local_srt, sched.lrt)}
    chunk = kw["chunk_size"] if kw.get("chunk_prefill") else 0
    want = _expected_launches(sched, zero, kw["decode_block"], chunk)
    if len(fetches) != ticks or ticks == 0:
        raise AssertionError(f"{len(fetches)} host fetches in {ticks} ticks")
    if counts != want:
        raise AssertionError(f"launches {counts}, lane flags predict {want}")
    if set(out) != {r.request_id for r in reqs}:
        raise AssertionError("not one record per request")
    if sched.srt.pool.held_slots or sched.lrt.pool.held_slots:
        raise AssertionError("slots held after drain")
    return out, sched, counts, ticks, wall


def _add(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def mesh_phase(eng, reqs, ref):
    """The (1, 1) mesh on the card: the first ``MESH_REQUESTS`` of the
    stream trace at their median S confidence in ``ref`` (the stream
    phase's records), each pool dtype served without the mesh, through
    it twice, and without it again (each run on a fresh scheduler,
    ``_counted_run``: one fetch per tick, the launches the lane flags
    predict): every run's tokens, statuses and offloads bitwise the
    first's, every pool's invariants after each run; ms per tick and
    req/s of each run.  Returns the mesh runs' launches."""
    import numpy as np
    from repro_torch.launch.mesh import make_serving_mesh
    reqs = reqs[:MESH_REQUESTS]
    theta = float(np.float32(np.median([ref[r.request_id]["confidence"]
                                        for r in reqs])))
    mesh = make_serving_mesh(1, 1)
    total = {}
    eng.hi = dataclasses.replace(eng.hi, theta=theta)
    try:
        for kv in ("bf16", "int8"):
            kw = dict(STREAM_KW, kv_dtype=kv)
            runs = []
            for on in (False, True, True, False):
                out, sched, counts, ticks, wall = _counted_run(
                    eng, reqs, kw, **({"mesh": mesh} if on else {}))
                for rt in (*sched.srts, sched.lrt):
                    rt.pool.check_invariants()
                runs.append((on, out, ticks, wall))
                if on:
                    _add(total, counts)
                    report, mesh_counts = sched.mesh_report, counts
            first = runs[0][1]
            same = all(np.array_equal(first[rid]["tokens"], o[rid]["tokens"])
                       and first[rid]["status"] == o[rid]["status"]
                       and first[rid]["offloaded"] == o[rid]["offloaded"]
                       for _, o, _, _ in runs for rid in first)
            n_off = sum(r["offloaded"] for r in first.values())
            side = {flag: [(t, w) for on, _, t, w in runs if on == flag]
                    for flag in (False, True)}
            ms = {flag: float(np.mean([w / t for t, w in v])) * 1e3
                  for flag, v in side.items()}
            rps = {flag: float(np.mean([len(reqs) / w for _, w in v]))
                   for flag, v in side.items()}
            log(f"  mesh (1, 1), {kv} pools, theta {theta:.6f}, runs off, "
                f"on, on, off: {', '.join(f'{t} ticks {w * 1e3:.1f} ms' for _, _, t, w in runs)}"
                f"; records of every run equal to the first (tokens, "
                f"status, offload): {same}; offloaded {n_off} of "
                f"{len(first)}; without the mesh {rps[False]:.2f} req/s, "
                f"{ms[False]:.1f} ms a tick; with it {rps[True]:.2f} req/s,"
                f" {ms[True]:.1f} ms a tick ({rps[True] / rps[False]:.3f}x "
                f"req/s); one host fetch per tick; L tier cut "
                f"{report['kinds']}, replicated {report['replicated']}; "
                f"launches of a mesh run {mesh_counts} as the lane flags "
                "predict")
            if not same or not 0 < n_off < len(first):
                raise AssertionError(f"mesh (1, 1) {kv}: records differ from "
                                     "mesh=None, or one branch never ran")
    finally:
        eng.hi = dataclasses.replace(eng.hi, theta=THETA)
        eng._stream = None
    return total


def fault_stream_phase(eng, reqs, ref):
    """The stream trace under ``FAULTS`` with ``RETRY`` and
    ``validate=True``, twice, each on a fresh scheduler: one record per
    request with a status of ``STATUSES``, some ``ok`` and some
    ``degraded_local``, the breaker opened and closed again, no slot held,
    one fetch per tick and launches as the lane flags say; the two runs'
    records equal field by field (all but the wall-clock ``ttft``).  Then
    the pure delay ``DELAY``: every request served as in the fault-free
    run ``ref``, token for token.  Returns the launches."""
    import numpy as np
    from repro_torch.serving.faults import (STATUSES, CircuitBreaker,
                                            FaultSchedule, RetryPolicy)

    total = {}
    kw = dict(STREAM_KW, faults=FaultSchedule(**FAULTS),
              retry=RetryPolicy(**RETRY))
    runs = []
    for run in range(2):
        out, sched, counts, ticks, wall = _counted_run(eng, reqs, kw)
        _add(total, counts)
        brk = sched._breaker
        statuses = [rec["status"] for rec in out.values()]
        if not set(statuses) <= set(STATUSES):
            raise AssertionError(f"statuses {set(statuses)}")
        if "ok" not in statuses or "degraded_local" not in statuses:
            raise AssertionError(f"statuses {sorted(set(statuses))}: need "
                                 "ok and degraded_local")
        if brk.opens < 1 or brk.state != CircuitBreaker.CLOSED:
            raise AssertionError(f"breaker opened {brk.opens} times, ends "
                                 f"{brk.state}: it must open and close")
        for rid, rec in out.items():
            if rec["status"] != "ok" or not rec["served_remote"]:
                if not np.array_equal(rec["tokens"], rec["s_tokens"]):
                    raise AssertionError(f"request {rid}: a local answer "
                                         "lost its S tokens")
            if not np.array_equal(rec["s_tokens"], ref[rid]["s_tokens"]):
                raise AssertionError(f"request {rid}: faults moved an S "
                                     "token")
        st = sched.stats
        n = {s: statuses.count(s) for s in STATUSES}
        log(f"  faults {FAULTS}, retry {RETRY}, run {run}: {wall * 1e3:.1f}"
            f" ms, {ticks} ticks, {len(out) / wall:.2f} req/s; statuses "
            f"{n}; breaker opened {brk.opens}x ({st['breaker_open_ticks']} "
            f"open ticks), closed at the end; escalation retries "
            f"{st['esc_retries']}, lost {st['esc_lost']}; one host fetch per "
            f"tick; launches {counts} as the lane flags predict; "
            f"{_graphs(sched)}")
        runs.append(out)
    for rid, rec in runs[0].items():
        for key, v in rec.items():
            if key != "ttft" and not np.array_equal(v, runs[1][rid][key]):
                raise AssertionError(f"request {rid}: {key} differs between"
                                     " two runs of one schedule")
    out, sched, counts, ticks, wall = _counted_run(
        eng, reqs, dict(STREAM_KW, faults=FaultSchedule(**DELAY),
                        retry=RetryPolicy(ack_timeout_ticks=8)))
    _add(total, counts)
    waits = []
    for rid, rec in out.items():
        if rec["status"] != ref[rid]["status"] or not np.array_equal(
                rec["tokens"], ref[rid]["tokens"]):
            raise AssertionError(f"request {rid}: a pure delay changed its "
                                 "answer")
        if rec["served_remote"]:
            waits.append(rec["queue_wait_ticks"])
    if not waits or min(waits) < DELAY["delay_ticks"]:
        raise AssertionError(f"queue waits {waits} under a delay of "
                             f"{DELAY['delay_ticks']}")
    log(f"  pure delay {DELAY}: {ticks} ticks, the fault-free records' "
        f"tokens and statuses for all {len(out)} requests; queue waits "
        f"{min(waits)}..{max(waits)} ticks; two runs of the fault schedule "
        "gave equal records")
    return total


def observability_phase(eng, reqs, keep: Path | None):
    """The stream trace with every collector off, then with
    ``Telemetry``, ``GateAudit``, ``SLOWatchdog`` and ``FlightRecorder``
    on, each on a fresh scheduler: the same tokens and confidences, one
    fetch per tick, one scheduler build for the run.  Prints TTFT / TPOT
    quantiles, the audit's decision counts and the host's ms per tick with
    the collectors on and off; with ``keep``, writes the Chrome trace there
    and parses it back.  Returns the launches."""
    import numpy as np
    from repro_torch.serving import trace_export
    from repro_torch.serving.audit import (GateAudit, SLOThresholds,
                                           SLOWatchdog)
    from repro_torch.serving.flight_recorder import FlightRecorder
    from repro_torch.serving.telemetry import Telemetry

    total = {}
    off, _, counts, ticks_off, wall_off = _counted_run(eng, reqs, STREAM_KW)
    _add(total, counts)
    tel, aud = Telemetry(), GateAudit()
    wd = SLOWatchdog(SLOThresholds(ttft_p95=60.0, tpot_p95=10.0))
    fr = FlightRecorder(capacity=16)
    builds0 = eng.stats["stream_compiles"]
    on, sched, counts, ticks_on, wall_on = _counted_run(
        eng, reqs, STREAM_KW, telemetry=tel, audit=aud, watchdog=wd,
        flight_recorder=fr)
    _add(total, counts)
    if eng.stats["stream_compiles"] != builds0 + 1 or \
            sched.counters.compiles != 1 or len(tel.ticks) != ticks_on:
        raise AssertionError("the collectors changed the scheduler builds "
                             "or the ticks")
    for rid, rec in off.items():
        if not np.array_equal(on[rid]["tokens"], rec["tokens"]) or \
                on[rid]["confidence"] != rec["confidence"]:
            raise AssertionError(f"request {rid}: collectors on changed "
                                 "its tokens or confidence")
    if set(tel.traces) != set(on) or aud.decisions == 0:
        raise AssertionError("spans or audit records missing")
    h = tel.histogram_summary()
    phases = {p: s / ticks_on * 1e3 for p, s in tel.phase_summary().items()
              if s}
    kinds = {}
    for r in aud.records:
        kinds[r.kind] = kinds.get(r.kind, 0) + 1
    q = {k: {p: round(h[k].get(p, math.nan) * 1e3, 2)
             for p in ("p50", "p95", "p99")} for k in ("ttft", "tpot")}
    log(f"  collectors off: {ticks_off} ticks, {wall_off / ticks_off * 1e3:.2f}"
        f" host ms per tick; on: {ticks_on} ticks, "
        f"{wall_on / ticks_on * 1e3:.2f} host ms per tick (phases, ms per "
        f"tick: { {p: round(v, 3) for p, v in phases.items()} }); tokens "
        f"and confidences equal; one host fetch per tick; one scheduler "
        f"build")
    log(f"  TTFT / TPOT quantiles (ms): {q}; audit {aud.decisions} "
        f"decisions {kinds}, {aud.outcomes} outcomes, ECE "
        f"{aud.ece():.4f}, offload rate {aud.offload_rate():.3f}; watchdog "
        f"breaches {len(wd.breaches)}; flight-recorder ring "
        f"{len(fr.ring)}, dumps {len(fr.dumps)}")
    if keep is not None:
        keep.mkdir(parents=True, exist_ok=True)
        path = keep / f"{ARCH}_stream_telemetry.json"
        trace_export.write_chrome_trace(tel, str(path))
        ev = json.loads(path.read_text())["traceEvents"]
        ends = {e["args"]["request_id"] for e in ev
                if e["ph"] == "i" and e["name"].startswith("terminal:")}
        if ends != set(on):
            raise AssertionError("the Chrome trace lost a request")
        log(f"  Chrome trace {path} ({path.stat().st_size / 1e6:.2f} MB, "
            f"{len(ev)} events) parsed back: a terminal per request")
    return total


def _spec_oracle(eng, reqs, out, kw):
    """The first ``SPEC_ORACLE`` requests through the port's host oracle
    on the card.  Each request's tokens must equal the oracle's up to their
    first difference, and that difference may only fall on a position the
    oracle chose by a margin under ``SPEC_MARGIN_TOL`` (after it the two
    histories part).  Returns how many requests equal the oracle
    throughout (their rounds too, where every margin is decisive) and how
    many tokens were compared."""
    import numpy as np
    from repro_torch.serving.batcher import pad_to_bucket
    from repro_torch.serving.token_cascade import TokenCascade

    tc = TokenCascade(s_cfg=eng.s.cfg, l_cfg=eng.l.cfg,
                      s_params=eng.s.params, l_params=eng.l.params,
                      hi=eng.hi, block=kw["decode_block"],
                      cache_len=CACHE_LEN)
    whole = compared = 0
    for r in reqs[:SPEC_ORACLE]:
        prompt = np.zeros(pad_to_bucket(len(r.prompt), kw["buckets"]),
                          np.int32)
        prompt[: len(r.prompt)] = r.prompt
        ref = tc.generate_speculative(prompt[None],
                                      min(r.max_new_tokens, MAX_NEW))
        got, want = out[r.request_id], ref["tokens"][0]
        diff = np.flatnonzero(got["tokens"] != want)
        if len(diff):
            j = int(diff[0])
            if ref["margins"][j] > SPEC_MARGIN_TOL:
                raise AssertionError(
                    f"request {r.request_id}: {got['tokens']} != the "
                    f"oracle's {want} at position {j}, chosen by a margin "
                    f"of {ref['margins'][j]:.3g}")
            compared += j
            continue
        compared += len(want)
        whole += 1
        if (ref["margins"] > SPEC_MARGIN_TOL).all() and \
                got["rounds"] != ref["rounds"]:
            raise AssertionError(f"request {r.request_id}: rounds "
                                 f"{got['rounds']} != {ref['rounds']}")
    return whole, compared


def speculative_phase(eng, reqs, plain):
    """``serve_stream(..., speculative=True)`` on the stream trace
    (``SPEC_KW``): at theta 0 (never escalates) the tokens are the plain
    stream's S tokens ``plain``; at theta 0.6 the first ``SPEC_ORACLE``
    requests equal the host oracle on decisive positions.  Each run: one
    fetch per tick and launches as the lane flags say, the chunk kernel
    once per L layer and verify tick.  Returns the launches and the chunk
    kernel's launches at the verify shape (both runs: at theta 0 the
    verify chunk still runs, as the L tier's catch-up), bf16 and int8.
    Then the theta 0.6 run again over int8 pools: launches as the lane
    flags say, and the tokens' agreement with the bf16 run (reported)."""
    import numpy as np
    total = {}
    try:
        eng.hi = dataclasses.replace(eng.hi, theta=0.0)
        out, sched, counts, ticks, wall = _counted_run(eng, reqs, SPEC_KW)
        _add(total, counts)
        for rid, rec in out.items():
            if not np.array_equal(rec["tokens"], plain[rid]["s_tokens"]):
                raise AssertionError(f"request {rid}: speculative at theta 0"
                                     " != the plain stream's S tokens")
        st = sched.stats
        verify0 = sched.lrt.lane_ticks["live"]
        if st["escalated_blocks"] or st["accepted"] != st["drafted"]:
            raise AssertionError(f"theta 0 escalated: {dict(st)}")
        log(f"  speculative, theta 0: {ticks} ticks, {len(out) / wall:.2f} "
            f"req/s; every draft accepted ({st['drafted']}); tokens equal "
            "to the plain stream's S tokens")
        eng.hi = dataclasses.replace(eng.hi, theta=THETA)
        out, sched, counts, ticks, wall = _counted_run(eng, reqs, SPEC_KW)
        _add(total, counts)
        _check_spec_outputs(out, reqs, eng.l.cfg)
        st = sched.stats
        verify = sched.lrt.lane_ticks["live"]
        n_l = eng.l.cfg.num_layers
        lane = n_l * sched.lrt.lane_ticks["chunk"] + \
            eng.s.cfg.num_layers * sched.srt.lane_ticks["chunk"]
        if counts["decode_attention_chunk_paged"] != n_l * verify + lane:
            raise AssertionError("chunk kernel launches != verify ticks x "
                                 "L layers + the chunk lanes'")
        whole, compared = _spec_oracle(eng, reqs, out, SPEC_KW)
        if whole < SPEC_MIN_EQUAL:
            raise AssertionError(f"{whole} of {SPEC_ORACLE} requests equal "
                                 f"to the oracle throughout (need "
                                 f"{SPEC_MIN_EQUAL})")
        n_tok = sum(len(r["tokens"]) for r in out.values())
        log(f"  speculative, theta {THETA}: {wall * 1e3:.1f} ms, {ticks} "
            f"ticks ({verify} ran the verify lane), {len(out) / wall:.2f} "
            f"req/s, {n_tok / wall:.1f} tok/s; drafted {st['drafted']}, "
            f"accepted {st['accepted']} (rate "
            f"{st['accepted'] / max(st['drafted'], 1):.3f}), blocks "
            f"{st['blocks']}, escalated {st['escalated_blocks']}; chunk "
            f"kernel {counts['decode_attention_chunk_paged']} launches = "
            f"{n_l} x {verify} verify ticks + {lane} chunk-lane; one host "
            f"fetch per tick; {whole} of {SPEC_ORACLE} requests equal to the "
            f"host oracle throughout, {compared} tokens compared (a "
            f"difference only where the margin is under "
            f"{SPEC_MARGIN_TOL:g})")
        # over int8 pools: the verify chunk's 4 tokens append into a
        # page and may rewrite its scale; the int8 chunk body runs at the
        # verify shape
        out8, sched8, counts, ticks, wall = _counted_run(
            eng, reqs, dict(SPEC_KW, kv_dtype="int8"))
        _add(total, counts)
        _check_spec_outputs(out8, reqs, eng.l.cfg)
        verify8 = sched8.lrt.lane_ticks["live"]
        same = [np.mean(out8[r.request_id]["tokens"]
                        == out[r.request_id]["tokens"]) for r in reqs]
        st = sched8.stats
        log(f"  speculative over int8 pools, theta {THETA}: {ticks} ticks "
            f"({verify8} verify), {len(out8) / wall:.2f} req/s; accepted "
            f"{st['accepted']} of {st['drafted']}; int8 chunk kernel "
            f"{counts['decode_attention_chunk_paged[int8]']} launches as the"
            f" lane flags predict; tokens equal to the bf16 run's at "
            f"{np.mean(same):.3f} of positions (free run, reported)")
    finally:
        eng.hi = dataclasses.replace(eng.hi, theta=THETA)
    return total, n_l * (verify0 + verify), n_l * verify8


def _check_spec_outputs(out, reqs, cfg):
    import numpy as np
    for r in reqs:
        rec = out[r.request_id]
        n = min(r.max_new_tokens, MAX_NEW)
        if rec["status"] != "ok" or len(rec["tokens"]) != n:
            raise AssertionError(f"request {r.request_id}: {rec['status']}, "
                                 f"{len(rec['tokens'])} tokens, want {n}")
        if not ((rec["tokens"] >= 0) & (rec["tokens"] < cfg.vocab_size)).all():
            raise AssertionError("token ids out of range")
        if sum(k for _, k in rec["rounds"]) + 1 < n:
            raise AssertionError("rounds do not account for the tokens")
        if not (np.isfinite(rec["confidence"])
                and 0 <= rec["confidence"] <= 1):
            raise AssertionError("confidence not finite in [0, 1]")


def ssm_speculative_phase():
    """mamba2-370m at full width cut to ``CHUNK_DEPTH`` layers (S 2):
    speculative with the chunk lane on (``CHUNK_KW`` with a 64 bucket,
    whose prompts take the admit lane), the S draft staging
    every step's state and the verify rolling both tiers back through it.
    Theta 0 equals the plain stream's S tokens; theta 0.6 equals the host
    oracle on decisive positions.  Reports the state bytes the lane copies
    a tick, here and at full depth.  Returns the launches."""
    import numpy as np
    from repro_torch.configs.base import HIConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.batcher import Request

    cfg = dataclasses.replace(ARCHS[SSM_ARCH], num_layers=CHUNK_DEPTH)
    eng = engine_mod.build_engine(
        cfg, HIConfig(theta=THETA, capacity_factor=CAPACITY), seed=0,
        cache_len=CACHE_LEN, max_new_tokens=MAX_NEW, device="cuda")
    rng = np.random.default_rng(6)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, int(n))
                    .astype(np.int32), max_new_tokens=MAX_NEW)
            for i, n in enumerate(np.concatenate(
                [rng.integers(24, 65, 2), rng.integers(65, 201, 4)]))]
    # prompts of the 64 bucket take the admit lane (ssd_chunk), the
    # longer ones the chunk lane
    plain_kw = dict(CHUNK_KW, buckets=(64, 128, 256))
    kw = dict(plain_kw, speculative=True)
    total = {}
    plain, _, counts, _, _ = _counted_run(eng, reqs, plain_kw)
    _add(total, counts)
    try:
        eng.hi = dataclasses.replace(eng.hi, theta=0.0)
        out, _, counts, _, _ = _counted_run(eng, reqs, kw)
        _add(total, counts)
        for rid, rec in out.items():
            if not np.array_equal(rec["tokens"], plain[rid]["s_tokens"]):
                raise AssertionError(f"{SSM_ARCH} request {rid}: "
                                     "speculative at theta 0 != the plain "
                                     "stream's S tokens")
        eng.hi = dataclasses.replace(eng.hi, theta=THETA)
        out, sched, counts, ticks, wall = _counted_run(eng, reqs, kw)
        _add(total, counts)
        _check_spec_outputs(out, reqs, cfg)
        whole, compared = _spec_oracle(eng, reqs, out, kw)
        if compared == 0:
            raise AssertionError("no decisive token to compare")
    finally:
        eng.hi = dataclasses.replace(eng.hi, theta=THETA)
    st = sched.stats

    def row_bytes(rt):
        # state and conv window of one slot in one layer of a tier
        return sum(t[0, 0].numel() * t.element_size()
                   for t in (rt.pool.buffers["state"],
                             rt.pool.buffers["conv"]))

    kb, b = kw["decode_block"], kw["num_slots"]
    s_row, l_row = row_bytes(sched.srt), row_bytes(sched.lrt)
    # the S draft copies every step's rows; the verify one copy before its
    # chunk and one per chunk step
    per_tick = (kb * eng.s.cfg.num_layers * s_row
                + (kb + 1) * cfg.num_layers * l_row) * b
    full = ARCHS[SSM_ARCH]
    full_s = full.s_variant(eng.hi.s_scale)
    full_tick = (kb * full_s.num_layers * s_row
                 + (kb + 1) * full.num_layers * l_row) * b
    log(f"  speculative {cfg.name} at {CHUNK_DEPTH} layers (S "
        f"{eng.s.cfg.num_layers}), {len(reqs)} prompts, {kw}: theta 0 equal"
        f" to the plain stream's S tokens; theta {THETA}: {ticks} ticks, "
        f"{wall * 1e3:.1f} ms, drafted {st['drafted']}, accepted "
        f"{st['accepted']}; {whole} of {min(SPEC_ORACLE, len(reqs))} requests"
        f" equal to the host oracle throughout, {compared} tokens compared;"
        f" recurrent state copied for the rollback: "
        f"{per_tick / 2 ** 20:.1f} MiB a tick here, "
        f"{full_tick / 2 ** 20:.1f} MiB at full depth ({full.num_layers} / "
        f"{full_s.num_layers} layers; not run)")
    del eng
    return total


def _check_stream_outputs(out, reqs, cfg, theta, statuses):
    import numpy as np
    for r in reqs:
        rec = out[r.request_id]
        if rec["status"] not in statuses:
            raise AssertionError(f"status {rec['status']!r}")
        n = min(r.max_new_tokens, MAX_NEW)
        if rec["status"] == "ok" and len(rec["tokens"]) != n:
            raise AssertionError(f"request {r.request_id}: "
                                 f"{len(rec['tokens'])} tokens, want {n}")
        if not ((rec["tokens"] >= 0) & (rec["tokens"] < cfg.vocab_size)).all():
            raise AssertionError("token ids out of range")
        if not (np.isfinite(rec["confidence"])
                and 0 <= rec["confidence"] <= 1):
            raise AssertionError("confidence not finite in [0, 1]")
        if rec["offloaded"] != (rec["confidence"] < theta):
            raise AssertionError("offloaded != confidence < theta")
        if rec["served_remote"] and not rec["offloaded"]:
            raise AssertionError("served remote without offloading")
        if not rec["served_remote"] and not np.array_equal(
                rec["tokens"], rec["s_tokens"]):
            raise AssertionError("a local answer lost its S tokens")


# ---------------------------------------------------------------------------
# the paper's classifier cascade, the legacy baseline, temperature sampling
# ---------------------------------------------------------------------------

def _gap_theta(conf):
    """A theta in the widest gap between neighbouring confidences within 20
    of the median: no row sits within rounding of it."""
    import numpy as np
    c = np.sort(np.asarray(conf, np.float64))
    mid = len(c) // 2
    j = mid - 20 + int(np.argmax(np.diff(c[mid - 20:mid + 20])))
    return float((c[j] + c[j + 1]) / 2)


def cascade_phase():
    """``HICascade`` over random-init SML_CIFAR / LML_CIFAR at their
    published widths: the paper's CIFAR-10 test size (10,000 images of
    ``data/images``) in batches of 2,000, theta at the S tier's median
    confidence, capacity ``CASCADE_CAPACITY`` (under the half that wants to
    offload, so every batch drops escalations).
    ``use_kernel=True`` launches hi_gate once per batch and must give the
    plain metric's offload mask, served set and drops exactly, and its
    predictions wherever the S tier's top1 - top2 probability margin
    exceeds ``CASCADE_MARGIN``.  SML_BINARY under the binary-relevance rule
    scores with the sigmoid and launches nothing.  Then the paper's
    published numbers through the port's replay.  Returns the launches of
    the kernel path's run."""
    import numpy as np
    import torch
    from repro_torch.configs.base import HIConfig
    from repro_torch.core import metrics, replay
    from repro_torch.core.cascade import HICascade
    from repro_torch.data.images import make_dataset
    from repro_torch.kernels import hi_gate as hg
    from repro_torch.kernels import ops
    from repro_torch.models import cnn

    g = torch.Generator(device="cuda").manual_seed(CASCADE_SEED)
    sp = cnn.init_cnn(g, cnn.SML_CIFAR, "cuda")
    lp = cnn.init_cnn(g, cnn.LML_CIFAR, "cuda")
    t0 = time.perf_counter()
    x, labels = make_dataset(CASCADE_IMAGES, seed=CASCADE_DATA_SEED)
    xg = torch.from_numpy(x).cuda()
    batches = xg.split(CASCADE_BATCH)
    log(f"  {CASCADE_IMAGES} images of data/images (seed "
        f"{CASCADE_DATA_SEED}) in {time.perf_counter() - t0:.1f} s; "
        f"SML_CIFAR {cnn.num_params(sp):,} params, LML_CIFAR "
        f"{cnn.num_params(lp):,}")

    def s_apply(p, xx):
        return cnn.apply_cnn(p, cnn.SML_CIFAR, xx)

    def l_apply(p, xx):
        return cnn.apply_cnn(p, cnn.LML_CIFAR, xx)

    with torch.inference_mode():
        s_logits = [s_apply(sp, b) for b in batches]
        theta = _gap_theta(torch.cat(s_logits).softmax(-1).amax(-1).cpu())
        hi = HIConfig(theta=theta, capacity_factor=CASCADE_CAPACITY)
        runs = {}
        for use_kernel in (True, False):
            casc = HICascade(s_apply, l_apply, hi, use_kernel=use_kernel)
            casc.infer(sp, lp, batches[0])          # warm
            torch.cuda.synchronize()
            if use_kernel:
                ops.reset_launch_counts()
            t0 = time.perf_counter()
            outs = [casc.infer(sp, lp, b) for b in batches]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if use_kernel:
                launches = ops.launch_counts()
            runs[use_kernel] = (outs, dt)
        want = dict.fromkeys(_kernel_names(), 0)
        want["hi_gate"] = len(batches)
        if launches != want:
            raise AssertionError(f"cascade launches {launches}, want {want}")
        n_cmp = 0
        for b, (k, p, sl) in enumerate(zip(runs[True][0], runs[False][0],
                                           s_logits)):
            for key in ("offload_mask", "served_remote", "dropped"):
                if not torch.equal(k[key], p[key]):
                    raise AssertionError(f"batch {b}: {key} differs between "
                                         "the kernel and the plain metric")
            top2 = sl.softmax(-1).topk(2, -1).values
            sure = (top2[:, 0] - top2[:, 1]) > CASCADE_MARGIN
            if not torch.equal(k["pred"][sure], p["pred"][sure]):
                raise AssertionError(f"batch {b}: predictions differ")
            err = float((k["conf"] - p["conf"]).abs().max())
            if not err <= CONF_ATOL:
                raise AssertionError(f"batch {b}: conf err {err:.2e}")
            n_cmp += int(sure.sum())
        outs = runs[True][0]
        pred = torch.cat([o["pred"] for o in outs]).cpu().numpy()
        served = torch.cat([o["served_remote"] for o in outs]).cpu().numpy()
        offl = torch.cat([o["offload_mask"] for o in outs]).cpu().numpy()
        drops = [int(o["dropped"]) for o in outs]
        if not (0 < offl.sum() < len(offl) and sum(drops) > 0):
            raise AssertionError(f"offloaded {offl.sum()}, drops {drops}: "
                                 "both branches and the drop must run")
        rep = metrics.hi_report(pred, None, served, offl, labels, None, 0.5)
        n = CASCADE_IMAGES
        log(f"  theta {theta:.6f} (median S confidence): offloaded "
            f"{int(offl.sum())}, served remote {int(served.sum())}, dropped "
            f"{sum(drops)} ({drops} per batch); hi_gate launches "
            f"{launches['hi_gate']} (one per batch); kernel path == plain "
            f"metric on masks, served sets and drops, predictions on "
            f"{n_cmp}/{n} rows with S margin > {CASCADE_MARGIN:g}")
        log(f"  cascade per {CASCADE_BATCH}-image batch: use_kernel "
            f"{runs[True][1] / len(batches) * 1e3:.2f} ms "
            f"({n / runs[True][1]:.0f} images/s), plain "
            f"{runs[False][1] / len(batches) * 1e3:.2f} ms "
            f"({n / runs[False][1]:.0f} images/s); random weights: "
            f"accuracy {100 * rep.accuracy:.2f}%, cost at beta 0.5 "
            f"{rep.cost:.1f} ({rep.cost_formula()})")
        # the dog filter: one logit, the sigmoid, no kernel
        bp = cnn.init_cnn(g, cnn.SML_BINARY, "cuda")

        def b_apply(p, xx):
            return cnn.apply_cnn(p, cnn.SML_BINARY, xx)

        before = hg.hi_gate_cuda.launches
        bout = HICascade(b_apply, b_apply,
                         HIConfig(theta=0.5, binary_relevance=True),
                         use_kernel=True).infer(bp, bp, batches[0])
        sig = torch.sigmoid(b_apply(bp, batches[0]))[:, 0]
        if hg.hi_gate_cuda.launches != before or not torch.equal(
                bout["conf"], sig):
            raise AssertionError("the binary head did not take the sigmoid")
        if not torch.equal(bout["offload_mask"], sig >= 0.5):
            raise AssertionError("binary relevance: offload != p >= theta")
    # the paper's published numbers through the port's replay
    t1 = replay.table1(0.5)
    red = (replay.table1_cost_reduction(0.25),
           replay.table1_cost_reduction(0.999))
    f8 = replay.fig8_hi_vs_full_offload(0.5)
    dog = replay.DogReplay()
    log(f"  replay (beta 0.5): Table 1 costs no-offload "
        f"{t1['no_offload'].cost} (paper 3742), full offload "
        f"{t1['full_offload'].cost} (paper 10000*beta + 500 = 5500), HI "
        f"{t1['hi'].cost} (paper 3550*beta + 1648 = 3423), HI accuracy "
        f"{100 * t1['hi'].accuracy:.2f}% (paper 83.52%); cost reduction vs "
        f"full offload {red[0]:.2f}% at beta 0.25, {red[1]:.2f}% at 0.999 "
        f"(paper 14-49%); Table 3 offloaded {dog.n_offloaded} (paper "
        f"4433); Fig. 8 latency reduction "
        f"{f8['latency_reduction_pct']:.2f}% (paper 63.15%), offload "
        f"reduction {f8['offload_reduction_pct']:.2f}% (paper 64.45%)")
    if not (t1["no_offload"].cost == 3742 and t1["full_offload"].cost == 5500
            and t1["hi"].cost == 3423 and dog.n_offloaded == 4433
            and abs(f8["latency_reduction_pct"] - 63.15) < 0.2
            and abs(f8["offload_reduction_pct"] - 64.45) < 0.2
            and 13 < red[0] < 20 and 45 < red[1] < 52):
        raise AssertionError("the replay lost the paper's numbers")
    return launches, {"batch_ms": runs[True][1] / len(batches) * 1e3,
                      "plain_batch_ms": runs[False][1] / len(batches) * 1e3}


def _forced_logits(tier, tokens, toks):
    """The tier's drain-path logits (prefill + decode_step on a fresh cache)
    along ``toks``: (T, B, V) on the card; step i decides toks[:, i]."""
    import torch
    from repro_torch.models import model_zoo
    b = tokens.shape[0]
    cache = model_zoo.init_cache(tier.cfg, b, CACHE_LEN, device="cuda")
    lg, cache = model_zoo.prefill(tier.params, tier.cfg, tokens, cache)
    out = []
    for i in range(toks.shape[1]):
        out.append(lg)
        lg, cache = model_zoo.decode_step(tier.params, tier.cfg,
                                          toks[:, i:i + 1], cache)
    return torch.stack(out)


def _first_undecided(z, margin):
    """(T, B, V) scores -> (B,) the first step whose top1 - top2 is under
    ``margin`` (T if none)."""
    import numpy as np
    top2 = z.topk(2, dim=-1).values
    dec = ((top2[..., 0] - top2[..., 1]) > margin).cpu().numpy()
    return np.where(dec.all(0), dec.shape[0], np.argmin(dec, 0))


def legacy_phase(eng):
    """``serve_legacy`` on the full-width qwen2 cascade: one batch of 8
    random 128-token prompts, 16 new tokens.  The drain kernel launches
    once per layer and token of each tier's per-token loop, (128 + 16) x 7
    for S and (128 + 16) x 28 for the L tier on the routed rows, and no
    hi_gate; against ``serve`` on the same batch: the offload flags
    exactly, mean confidences to ``LEGACY_CONF_TOL``, tokens up to each
    row's first position whose teacher-forced top1 - top2 logit margin is
    under ``LEGACY_MARGIN``.  Returns the launches and both req/s."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops

    cfg = eng.l.cfg
    toks = np.random.default_rng(LEGACY_SEED).integers(
        1, cfg.vocab_size, (BATCH, LEGACY_BUCKET)).astype(np.int32)
    eng.serve(toks)                                   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new = eng.serve(toks)
    t_serve = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    old = eng.serve_legacy(toks)
    t_legacy = time.perf_counter() - t0
    launches = ops.launch_counts()
    steps = LEGACY_BUCKET + MAX_NEW
    want = dict.fromkeys(_kernel_names(), 0)
    want["decode_attention"] = steps * (eng.s.cfg.num_layers
                                        + cfg.num_layers)
    if launches != want:
        raise AssertionError(f"legacy launches {launches}, want {want}")
    if not np.array_equal(old["offloaded"], new["offloaded"]) or \
            not np.array_equal(old["served_remote"], new["served_remote"]):
        raise AssertionError("legacy and serve route differently")
    cerr = float(np.abs(old["confidence"] - new["confidence"]).max())
    if not cerr <= LEGACY_CONF_TOL:
        raise AssertionError(f"legacy confidence err {cerr:.2e}")
    dev = torch.as_tensor(toks, dtype=torch.int64, device="cuda")
    n_cmp = 0
    with torch.inference_mode():
        for tier, rows, key in ((eng.s, np.arange(BATCH), "s_tokens"),
                                (eng.l, np.flatnonzero(old["served_remote"]),
                                 "tokens")):
            if not len(rows):
                continue
            ref = torch.as_tensor(old[key][rows], dtype=torch.int64,
                                  device="cuda")
            first = _first_undecided(
                _forced_logits(tier, dev[rows], ref), LEGACY_MARGIN)
            for r, n in zip(rows, first):
                if not np.array_equal(new[key][r, :n], old[key][r, :n]):
                    raise AssertionError(f"row {r}: serve {new[key][r]} != "
                                         f"legacy {old[key][r]}")
                n_cmp += int(n)
    if n_cmp == 0:
        raise AssertionError("no decisive token to compare")
    rates = {"legacy_req_s": BATCH / t_legacy, "serve_req_s": BATCH / t_serve}
    log(f"  serve_legacy, {BATCH} prompts of {LEGACY_BUCKET}, {MAX_NEW} new "
        f"tokens: {t_legacy * 1e3:.1f} ms ({rates['legacy_req_s']:.2f} req/s)"
        f" against serve {t_serve * 1e3:.1f} ms ({rates['serve_req_s']:.2f} "
        f"req/s) on the same batch; decode_attention launches "
        f"{launches['decode_attention']} = {steps} x "
        f"({eng.s.cfg.num_layers} + {cfg.num_layers}), no hi_gate; offloads "
        f"equal, confidence err {cerr:.2e} (tol {LEGACY_CONF_TOL:g}), "
        f"{n_cmp} tokens equal up to a margin under {LEGACY_MARGIN:g}")
    return launches, rates


def _sampled_scores(tier, tokens, toks, seeds, temp):
    """``logits / t + gumbel`` along the drain path's tokens under each
    step's per-request keys: (T, B, V)."""
    import torch
    from repro_torch.serving import sampler
    lg = _forced_logits(tier, tokens, toks)
    v = lg.shape[-1]
    return lg / temp + torch.stack(
        [sampler.gumbel(sampler.request_keys(seeds, i), (v,))
         for i in range(toks.shape[1])])


def check_sampler_bits():
    """``request_keys`` and ``random_bits`` over the committed (seeds, token
    index) grid at (8, 151,936): the card's words equal the CPU's bit for
    bit, and the committed words, which were generated with jax."""
    import numpy as np
    import torch
    from repro_torch.serving import sampler
    seeds = torch.tensor(SAMPLER_SEEDS)
    idx = torch.tensor(SAMPLER_IDX)
    kc = sampler.request_keys(seeds, idx)
    kg = sampler.request_keys(seeds.cuda(), idx.cuda())
    bc = sampler.random_bits(kc, (SAMPLER_VOCAB,))
    bg = sampler.random_bits(kg, (SAMPLER_VOCAB,)).cpu()
    ends = torch.cat([bg[:, :2], bg[:, -2:]], 1).numpy()
    if not (torch.equal(kg.cpu(), kc) and torch.equal(bg, bc)
            and np.array_equal(kc.numpy(), np.asarray(SAMPLER_KEYS))
            and np.array_equal(ends, np.asarray(SAMPLER_BITS))):
        raise AssertionError("the card's sampler bits differ")
    log(f"  sampler: keys and bits of the ({len(SAMPLER_SEEDS)}, "
        f"{SAMPLER_VOCAB}) grid on the card equal the CPU's bit for bit "
        f"({bg.numel():,} words) and the committed jax words")


def sampler_step_times():
    """One sampling step at the S tier's shape, logits (8, 151,936) f32 at
    temperature 0.7: keys, threefry bits, gumbel, argmax, per-row select,
    in plain torch.  CUDA events over 50 calls, kernels per call from the
    profiler, greedy's argmax beside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import sampler
    gen = torch.Generator(device="cuda").manual_seed(3)
    seeds = torch.arange(8, device="cuda", dtype=torch.int32)
    idx = torch.full((8,), 5, device="cuda", dtype=torch.int32)
    temps = torch.full((8,), TEMPERATURE, device="cuda")
    sets = copies(lambda: (torch.randn((8, SAMPLER_VOCAB), generator=gen,
                                       device="cuda"),), 8 * SAMPLER_VOCAB * 4)

    def step(lg):
        return sampler.sample(sampler.request_keys(seeds, idx), lg, temps)

    ms = timed(step, sets, 50)
    greedy_ms = timed(sampler.greedy, sets, 50)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(10):
            step(*sets[i])
        torch.cuda.synchronize()
    n_kern = sum(e.count for e in prof.key_averages()
                 if e.device_type.name == "CUDA") / 10
    log(f"  sampling step (8, {SAMPLER_VOCAB}) f32 at t {TEMPERATURE}: "
        f"{ms * 1e3:.1f} us, {n_kern:.0f} kernels a step (plain torch; "
        f"greedy argmax {greedy_ms * 1e3:.1f} us)")
    return {"ms": ms, "kernels": n_kern, "greedy_ms": greedy_ms}


def temperature_phase(eng, reqs, greedy_out):
    """The qwen2 stream trace at temperature 0.7, each request's seed its
    id, theta 0 and capacity 1 (every answer the S tier's): ``serve`` by
    bucket (batches of 8, pad rows seeded -1) and ``serve_stream`` twice on
    one scheduler (the second run restores the prompts from the prefix
    cache).  The stream's tokens equal the drain's up to each request's
    first draw whose margin of ``logits / t + gumbel`` is under
    ``SAMPLE_MARGIN`` (teacher-forced on the drain path); the two stream
    runs give the same tokens; one host fetch per tick; some request parts
    from the greedy run's tokens (``greedy_out``).  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.batcher import pad_to_bucket

    buckets = STREAM_KW["buckets"]
    hi0 = eng.hi
    eng.hi = dataclasses.replace(hi0, theta=0.0, capacity_factor=1.0)
    eng.temperature = TEMPERATURE
    fetches = []
    real_fetch = engine_mod._host_fetch

    def counting_fetch(tree):
        fetches.append(1)
        return real_fetch(tree)

    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        drain, groups = {}, {}
        for r in reqs:
            groups.setdefault(pad_to_bucket(len(r.prompt), buckets),
                              []).append(r)
        for bucket, group in sorted(groups.items()):
            for at in range(0, len(group), BATCH):
                sub = group[at:at + BATCH]
                toks = np.zeros((BATCH, bucket), np.int32)
                seeds = np.full((BATCH,), -1, np.int32)
                for j, r in enumerate(sub):
                    toks[j, :len(r.prompt)] = r.prompt
                    seeds[j] = r.request_id
                out = eng.serve(toks, seeds=seeds)
                for j, r in enumerate(sub):
                    drain[r.request_id] = (toks[j], seeds[j], out["tokens"][j])
        torch.cuda.synchronize()
        t_drain = time.perf_counter() - t0
        engine_mod._host_fetch = counting_fetch
        runs = []
        for _ in range(2):
            ticks0 = eng.stats["stream_ticks"]
            n0 = len(fetches)
            t0 = time.perf_counter()
            runs.append(eng.serve_stream(reqs, **STREAM_KW))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            ticks = eng.stats["stream_ticks"] - ticks0
            if len(fetches) - n0 != ticks or ticks == 0:
                raise AssertionError(f"{len(fetches) - n0} fetches in "
                                     f"{ticks} ticks")
            log(f"  sampled serve_stream: {dt * 1e3:.1f} ms, {ticks} ticks, "
                f"{len(reqs) / dt:.2f} req/s; one host fetch per tick")
        launches = ops.launch_counts()
    finally:
        engine_mod._host_fetch = real_fetch
        eng.hi = hi0
        eng.temperature = 0.0
    a, b = runs
    for rid in a:
        if not np.array_equal(a[rid]["tokens"], b[rid]["tokens"]):
            raise AssertionError(f"request {rid}: two sampled runs differ")
    # stream against drain, teacher-forced on the drain path's S tier
    n_cmp = n_tok = 0
    with torch.inference_mode():
        by_bucket = {}
        for rid, (toks, seed, dtoks) in drain.items():
            by_bucket.setdefault(len(toks), []).append((rid, toks, seed,
                                                        dtoks))
        for rows in by_bucket.values():
            for at in range(0, len(rows), BATCH):
                sub = rows[at:at + BATCH]
                tk = torch.as_tensor(np.stack([r[1] for r in sub]),
                                     dtype=torch.int64, device="cuda")
                dt_ = torch.as_tensor(np.stack([r[3] for r in sub]),
                                      dtype=torch.int64, device="cuda")
                sd = torch.as_tensor([int(r[2]) for r in sub],
                                     device="cuda")
                z = _sampled_scores(eng.s, tk, dt_, sd, TEMPERATURE)
                # the drain drew these very tokens where the draw is decided
                first = _first_undecided(z, SAMPLE_MARGIN)
                draws = z.argmax(-1).T.cpu().numpy()
                for row, ((rid, _, _, dtoks), n) in enumerate(zip(sub, first)):
                    if not np.array_equal(draws[row, :n], dtoks[:n]):
                        raise AssertionError(f"request {rid}: the drain's "
                                             "tokens are not its draws")
                    got = a[rid]["tokens"]
                    m = min(int(n), len(got))
                    if not np.array_equal(got[:m], dtoks[:m]):
                        raise AssertionError(
                            f"request {rid}: stream {got} != drain "
                            f"{dtoks[:len(got)]}")
                    n_cmp += m
                    n_tok += len(got)
    differs = sum(not np.array_equal(a[r.request_id]["tokens"],
                                     greedy_out[r.request_id]["s_tokens"])
                  for r in reqs)
    if n_cmp == 0 or differs == 0:
        raise AssertionError(f"compared {n_cmp} tokens; {differs} requests "
                             "differ from greedy")
    log(f"  sampled at t {TEMPERATURE}, theta 0: drain by bucket "
        f"{t_drain * 1e3:.1f} ms; stream == drain on {n_cmp}/{n_tok} tokens "
        f"(up to a draw margin under {SAMPLE_MARGIN:g}); the two stream "
        f"runs equal; {differs}/{len(reqs)} requests differ from greedy; "
        f"launches {launches}")
    return launches


KERNEL_KINDS = (  # (kind, regex over the kernel's name), first match wins
    ("ssd_chunk", r"ssd_chunk_kernel"),
    # the drain kernel: its splits and their merge
    ("decode_attention", r"decode_attention_(split|combine)_kernel"),
    ("chunk_paged_attention", r"chunk_paged_attention_kernel"),
    ("paged_attention (decode)", r"paged_attention_split_kernel"),
    ("copy_pages", r"copy_pages_kernel"),
    ("hi_gate", r"hi_gate"),
    ("matmul (cuBLAS)", r"gemm|gemv|xmma|cutlass|nvjet|cublas|splitK"),
    ("other PyTorch kernels", r"."),
)


def trace_phase(eng, tokens, windows, keep: Path | None, kw=STREAM_KW,
                name=ARCH):
    """One more drain serve of ``tokens``, and one ``serve_stream`` call of
    8 requests (a tick window of the lanes of ``kw``, on the warm
    scheduler), each under ``torch.profiler``: the device's kernel time by
    kind, and its busy share of the host wall time.  ``windows(i)`` gives
    the i-th call's requests (``_trace`` calls each function twice).  The
    gzipped Chrome traces are kept in ``keep`` if given."""
    import itertools
    import tempfile
    calls = itertools.count()
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = keep or Path(tmp)
        out_dir.mkdir(parents=True, exist_ok=True)
        _trace(lambda: eng.serve(tokens), f"{name} drain serve",
               out_dir / f"{name}_serve_trace.json.gz")
        ticks0 = eng.stats["stream_ticks"]
        _trace(lambda: eng.serve_stream(windows(next(calls)), **kw),
               f"{name} serve_stream window",
               out_dir / f"{name}_stream_trace.json.gz",
               lambda: eng.stats["stream_ticks"] - ticks0)


def _window(reqs):
    """The first 8 of ``reqs`` as new requests."""
    from repro_torch.serving.batcher import Request
    return [Request(1000 + r.request_id, r.prompt,
                    max_new_tokens=r.max_new_tokens) for r in reqs[:8]]


def _trace(fn, label, path: Path, ticks=None):
    import gzip
    import re
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    fn()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(path))
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                  "gpu_memset")]
    if not kern:
        raise AssertionError("the trace holds no device activity")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in kern)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:            # union of the intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_kind, by_name = {}, {}
    for e in kern:
        kind = next(k for k, rx in KERNEL_KINDS if re.search(rx, e["name"]))
        for table, key in ((by_kind, kind), (by_name, e["name"])):
            n, t = table.get(key, (0, 0.0))
            table[key] = (n + 1, t + float(e["dur"]))
    total = sum(t for _, t in by_kind.values())
    extra = "" if ticks is None else f" ({ticks() // 2} ticks per call)"
    log(f"  traced {label}{extra}: {wall * 1e3:.1f} ms host wall under the "
        f"profiler, {plain_wall * 1e3:.1f} ms untraced just before; device "
        f"busy {busy / 1e3:.1f} ms = {busy / 1e3 / (wall * 1e3):.1%} of the "
        f"traced and {busy / 1e3 / (plain_wall * 1e3):.1%} of the untraced "
        f"wall; {len(kern)} device activities")
    for kind, (n, t) in sorted(by_kind.items(), key=lambda kv: -kv[1][1]):
        log(f"    {kind:32s} {n:6d} launches {t / 1e3:9.2f} ms "
            f"{t / total:6.1%} of device time")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"    {t / 1e3:9.2f} ms {n:6d}x  {name[:110]}")


# ---------------------------------------------------------------------------
# the MoE family (deepseek-moe-16b), the VLM, the enc-dec and the new dense
# configs
# ---------------------------------------------------------------------------

def check_moe_kernels(gen):
    """Kernels 1-5 against their plain versions at the MoE family's shapes,
    at the tolerances of the main path's cases (int8 bodies with garbage
    planted where no query looks): deepseek-moe-16b's L tier (16 / 16 heads
    of 128, group 1) and S tier (4 / 4), its vocab of 102,400 in hi_gate,
    the verify lane's q (8, 4, 16, 128), and llava-next-34b's group of 7
    (56 heads over 8 kv heads of 128) in the paged decode and chunk
    kernels.  Returns {kernel name: [entry, ...]} for the kernels line."""
    import numpy as np
    from repro_torch.configs.registry import ARCHS
    pos_l, pos_s, _ = _decode_positions()
    c, kb = STREAM_KW["chunk_size"], SPEC_KW["decode_block"]
    vpos = np.random.default_rng(4).integers(32, 528, 8).tolist()
    v = ARCHS[MOE_ARCH].vocab_size
    lt, st = f"L tier {MOE_ARCH}", f"S tier {MOE_ARCH}-s4"
    out = {}

    def put(entry):
        out.setdefault(entry["name"], []).append(entry)

    for shape in ((st, 8, v), (lt, 4, v), (f"chunk lane {MOE_ARCH}", 2, v)):
        put(check_hi_gate(gen, (shape,)))
    for shape in ((lt, 4, 16, 16, 128), (st, 8, 4, 4, 128)):
        put(check_decode_attention(gen, (shape,)))
    paged, chunked = "decode_attention_paged", "decode_attention_chunk_paged"
    for case in ((lt, 4, 16, 16, 128, L_PAGES, pos_l, NPG, False),
                 (st, 8, 4, 4, 128, S_PAGES, pos_s, NPG, False),
                 (LLAVA_GROUP7, 4, 56, 8, 128, L_PAGES, pos_l, NPG, True)):
        put(check_paged(gen, paged, 1, [case]))
    put(check_paged(gen, paged, 1, [(lt, 4, 16, 16, 128, L_PAGES, pos_l, NPG,
                                     True)], quant=True))
    for case in ((lt, 2, 16, 16, 128, L_PAGES, [0, 512 - c], NPG, False),
                 (st, 2, 4, 4, 128, S_PAGES, [0, 512 - c], NPG, False),
                 (LLAVA_GROUP7, 2, 56, 8, 128, L_PAGES, [0, 512 - c], NPG,
                  False)):
        put(check_paged(gen, chunked, c, [case]))
    put(check_paged(gen, chunked, c, [(lt, 2, 16, 16, 128, L_PAGES,
                                       [0, 512 - c], NPG, True)], quant=True))
    verify = (f"L verify {MOE_ARCH}", 8, 16, 16, 128, SPEC_L_PAGES, vpos, NPG)
    put(check_paged(gen, chunked, kb, [verify + (False,)], graph=True))
    put(check_paged(gen, chunked, kb, [verify + (True,)], quant=True,
                    graph=True))
    for case in ((lt, 28, L_PAGES, 16, 128, 4), (st, 7, S_PAGES, 4, 128, 8)):
        put(check_copy_pages(gen, cases=(case,)))
    put(check_copy_pages(gen, quant=True,
                         cases=((lt, 28, L_PAGES, 16, 128, 4),)))
    return out


# the MoE family's routed-expert shapes of the deepseek-moe.chat cell:
# (label, experts, d, f, tokens), top GROUPED_K; the first is the main row
GROUPED_SHAPES = (("L decode", 64, 2048, 1408, 8),
                  ("L chunk", 64, 2048, 1408, 2048),
                  ("S decode", 16, 512, 352, 32),
                  ("S chunk", 16, 512, 352, 2048))
GROUPED_K = 6
# kernel and plain version: float32 IEEE products over the same rows, only
# the order of the K sums differs (sums of up to 2,048 terms of O(1))
GROUPED_ATOL = 1e-4


def _grouped_case(gen, e, d, f, t):
    """Routed pairs of ``t`` tokens (a quarter dead, their x rows NaN) from
    the card's routing, and one weight set of ``e`` experts whose unhit
    experts are NaN: neither may reach the output."""
    import torch
    from repro_torch.kernels import ops
    x = torch.randn((t, d), generator=gen, device="cuda")
    live = torch.rand((t,), generator=gen, device="cuda") >= 0.25
    live[0] = True
    x[~live] = float("nan")
    logits = torch.randn((t, e), generator=gen, device="cuda")
    gate, pairs, offsets = ops.route_pairs(logits, GROUPED_K, live)
    idle = offsets[1:] == offsets[:-1]
    ws = []
    for shape, fan in (((e, d, f), d), ((e, d, f), d), ((e, f, d), f)):
        w = torch.randn(shape, generator=gen, device="cuda") / fan ** 0.5
        w[idle] = float("nan")
        ws.append(w)
    return x, pairs, offsets, ws, gate, live


def check_grouped_swiglu(gen):
    """The grouped expert kernel (``csrc/grouped_ffn.cu``, two launches a
    call) against its plain version at the cell's four shapes, dead tokens
    and unhit experts planted with NaN; the same bits twice; CUDA-event and
    profiler times over weight copies that exceed the L2 cache; the bound
    (every hit expert's three matrices, the live rows and the outputs
    once, or 2*3*d*f float32 FLOPs a pair); the library: the capacity
    path's ``torch.bmm`` over all E experts at the serving capacity 2.0
    and ``torch._grouped_mm`` over the same sorted rows, timed only where
    it gives the plain version's float32 within the tolerance.  Returns
    (the main row's entry, the other shapes' entries)."""
    import torch
    from repro_torch.kernels import grouped_ffn as gf
    k = GROUPED_K
    entries = []
    for label, e, d, f, t in GROUPED_SHAPES:
        x, pairs, offsets, (wg, wi, wo), gate, live = _grouped_case(
            gen, e, d, f, t)
        want = gf.grouped_swiglu_plain(x, pairs, offsets, wg, wi, wo, gate,
                                       k)
        got = gf.grouped_swiglu_cuda(x, pairs, offsets, wg, wi, wo, gate, k)
        again = gf.grouped_swiglu_cuda(x, pairs, offsets, wg, wi, wo, gate,
                                       k)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"grouped_swiglu {label}: not the same bits "
                                 "twice")
        if not torch.isfinite(got).all():
            raise AssertionError(f"grouped_swiglu {label}: a planted NaN "
                                 "reached the output")
        err = float((got - want).abs().max())
        if err > GROUPED_ATOL:
            raise AssertionError(f"grouped_swiglu {label}: max err {err:.3e}"
                                 f" > {GROUPED_ATOL}")
        n_live = int(live.sum())
        p, hit = k * n_live, int((offsets[1:] > offsets[:-1]).sum())
        del wg, wi, wo, want, got, again
        wbytes = 3 * e * d * f * 4
        copies_ = max(2, math.ceil(2 * L2_BYTES / wbytes))
        sets = []
        for _ in range(copies_):
            ws = [torch.randn(s_, generator=gen, device="cuda") / fan ** 0.5
                  for s_, fan in (((e, d, f), d), ((e, d, f), d),
                                  ((e, f, d), f))]
            sets.append((x, pairs, offsets, *ws, gate, k))
        iters = 200 if t * k <= 256 else 20
        ms = timed(gf.grouped_swiglu_cuda, sets, iters)
        dev_ms = device_ms(gf.grouped_swiglu_cuda, sets,
                           r"moe_gate_up_kernel|moe_down_kernel",
                           launches=2, iters=min(iters, 50))
        plain_ms = timed(gf.grouped_swiglu_plain, sets, max(2, iters // 10),
                         warmup=1)
        nbytes = 4 * (3 * hit * d * f + n_live * d + p * d)
        bound_ms, by = bound(nbytes, 6 * d * f * p)
        # the capacity path: every expert's (cap, d) buffer through bmm
        cap = max(1, math.ceil(t * k / e * 2.0))
        buf = torch.randn((e, cap, d), generator=gen, device="cuda")

        def capacity(x, pairs, offsets, wg, wi, wo, gate, k):
            h = torch.nn.functional.silu(torch.bmm(buf, wg)) * \
                torch.bmm(buf, wi)
            return torch.bmm(h, wo)
        bmm_ms = timed(capacity, sets, iters)
        n = int(offsets[-1])
        rows = pairs[:n]
        xs = x[rows // k]
        ends = torch.cumsum((offsets[1:] - offsets[:-1]).int(), 0,
                            dtype=torch.int32)

        def grouped_mm(x, pairs, offsets, wg, wi, wo, gate, k):
            h = torch.nn.functional.silu(torch._grouped_mm(xs, wg, offs=ends)) \
                * torch._grouped_mm(xs, wi, offs=ends)
            return torch._grouped_mm(h, wo, offs=ends) * gate[rows, None]
        lib_ms = lib_note = None
        try:
            plain = gf.grouped_swiglu_plain(*sets[0])[rows]
            lib_err = float((grouped_mm(*sets[0]) - plain).abs().max())
            if lib_err <= GROUPED_ATOL:
                lib_ms = timed(grouped_mm, sets, iters)
            else:
                lib_note = f"torch._grouped_mm float32 err {lib_err:.3e}"
        except (RuntimeError, TypeError, AttributeError) as exc:
            lib_note = f"torch._grouped_mm: {type(exc).__name__}: {exc}"[:200]
        shape = (f"{label}: {e} experts ({d}, {f}), {t} tokens ({n_live} "
                 f"live) x top {k}, {hit} experts hit")
        log(f"  grouped_swiglu {shape}  err {err:.2e}  {ms * 1e3:.1f} us "
            f"(device {dev_ms * 1e3:.1f} us = {bound_ms / dev_ms:.0%} of the "
            f"bound {bound_ms * 1e3:.1f} us, {by})  plain {plain_ms * 1e3:.1f}"
            f" us  capacity bmm {bmm_ms * 1e3:.1f} us  _grouped_mm "
            f"{'-' if lib_ms is None else f'{lib_ms * 1e3:.1f} us'}"
            f"{'' if lib_note is None else f' ({lib_note})'}")
        entries.append({"name": "grouped_swiglu", "route": "cuda",
                        "source": "src/repro_torch/csrc/grouped_ffn.cu",
                        "replaces": "none (the reference's capacity einsums,"
                                    " src/repro/models/moe.py)",
                        "shape": shape, "max_abs_err": err, "ms": ms,
                        "device_ms": dev_ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": by,
                        "library_ms": lib_ms, "capacity_bmm_ms": bmm_ms,
                        "library_note": lib_note})
        del sets, buf, xs
        torch.cuda.empty_cache()
    return entries[0], entries[1:]


def check_route_pairs(gen):
    """The routing kernels (two launches a call) against the plain version
    at the cell's four (tokens, experts) shapes, a third of the tokens
    dead, a row whose experts all tie and a row with its 6th and 7th
    tied: offsets and every pair's place exactly, the gates within 1e-6,
    the same bits twice; times beside the plain ops' and the bound (the
    logits read, the gates, pairs and offsets written).  Returns (the main
    row's entry, the other shapes' entries)."""
    import torch
    from repro_torch.kernels import grouped_ffn as gf
    k = GROUPED_K
    entries = []
    for label, e, _, _, t in GROUPED_SHAPES:
        def make():
            logits = torch.randn((t, e), generator=gen, device="cuda") * 2
            logits[0] = 0.5
            top = torch.sort(logits[1], descending=True).values
            logits[1][logits[1] == top[6]] = top[5]
            live = torch.rand((t,), generator=gen, device="cuda") > 0.33
            live[:2] = True
            return logits, k, live
        args = make()
        want = gf.route_pairs_plain(*args)
        got, again = gf.route_pairs_cuda(*args), gf.route_pairs_cuda(*args)
        torch.cuda.synchronize()
        if not (torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
                and all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(got, again))):
            raise AssertionError(f"route_pairs {label}: pairs or offsets "
                                 "differ from the plain version's, or "
                                 "between two runs")
        err = float((got[0] - want[0]).abs().max())
        if err > 1e-6:
            raise AssertionError(f"route_pairs {label}: gate err {err:.3e}")
        sets = [make() for _ in range(8)]
        ms = timed(gf.route_pairs_cuda, sets, 200)
        dev_ms = device_ms(gf.route_pairs_cuda, sets,
                           r"route_topk_kernel|route_scatter_kernel",
                           launches=2)
        plain_ms = timed(gf.route_pairs_plain, sets, 200)
        bound_ms, by = bound(4 * t * e + t + 12 * t * k + 8 * (e + 1), 0)
        shape = f"{label}: {t} tokens over {e} experts, top {k}"
        log(f"  route_pairs {shape}  exact, gates {err:.1e}  "
            f"{ms * 1e3:.1f} us (device {dev_ms * 1e3:.1f} us)  plain "
            f"{plain_ms * 1e3:.1f} us  bound {bound_ms * 1e3:.3f} us ({by})")
        entries.append({"name": "route_pairs", "route": "cuda",
                        "source": "src/repro_torch/csrc/grouped_ffn.cu",
                        "replaces": "none (the reference's top_k and "
                                    "capacity scatter)",
                        "shape": shape, "max_abs_err": err, "ms": ms,
                        "device_ms": dev_ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": by,
                        "library_ms": None})
    return entries[0], entries[1:]


def check_small_families():
    """Reduced llava-next-34b (forward with its patch prefix), whisper-large-
    v3 (forward; then ``precompute_cross`` and 12 decode steps, teacher-
    forced, over a float32 cache as the reference's decode == forward test
    takes), granite-3-2b and h2o-danube-3-4b (forward): the card against
    the CPU on the same params and inputs, float32 end to end
    (``SMALL_FWD_TOL``), and whisper's last decode step against its
    forward at the reference's 2e-3 (``tests/test_models.py:43``)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model_zoo, whisper
    for arch in ("granite-3-2b", "h2o-danube-3-4b", "llava-next-34b",
                 "whisper-large-v3"):
        cfg = ARCHS[arch].reduced()
        params = model_zoo.init_params(torch.Generator().manual_seed(3), cfg)
        rng = np.random.default_rng(3)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 12)))
        extra = {}
        if cfg.family == "vlm":
            extra["patches"] = torch.as_tensor(rng.normal(
                size=(2, cfg.num_patches, cfg.d_model)), dtype=torch.float32)
        if cfg.family == "encdec":
            extra["frames"] = torch.as_tensor(rng.normal(
                size=(2, cfg.num_audio_frames, cfg.d_model)),
                dtype=torch.float32)
        outs, steps = {}, {}
        for dev in ("cpu", "cuda"):
            p = _to(params, dev)
            kw = {k: v.to(dev) for k, v in extra.items()}
            outs[dev] = model_zoo.forward(p, cfg, toks.to(dev), **kw).cpu()
            if cfg.family == "encdec":
                cache = model_zoo.init_cache(cfg, 2, 16, torch.float32,
                                             device=dev)
                cache = whisper.precompute_cross(p, cfg, kw["frames"], cache)
                lg = []
                for t in range(toks.shape[1]):
                    out, cache = model_zoo.decode_step(
                        p, cfg, toks[:, t:t + 1].to(dev), cache)
                    lg.append(out.cpu())
                steps[dev] = torch.stack(lg, 1)
        err = float((outs["cuda"] - outs["cpu"]).abs().max())
        shape = tuple(outs["cuda"].shape)
        msg = (f"  small {arch} ({cfg.family}, reduced, card vs CPU): forward"
               f" {shape} max logit err {err:.2e} (tol {SMALL_FWD_TOL:g})")
        if not err <= SMALL_FWD_TOL:
            raise AssertionError(msg)
        if steps:
            derr = float((steps["cuda"] - steps["cpu"]).abs().max())
            ferr = float((steps["cpu"][:, -1] - outs["cpu"][:, -1])
                         .abs().max())
            msg += (f"; precompute_cross + 12 decode steps max err {derr:.2e}"
                    f" (tol {SMALL_FWD_TOL:g}), the CPU's last step vs its"
                    f" forward {ferr:.2e} (tol 2e-3)")
            if not (derr <= SMALL_FWD_TOL and ferr <= 2e-3):
                raise AssertionError(msg)
        log(msg)


def _param_bytes(params):
    return sum(v.numel() * v.element_size() for v in _leaves(params))


def _routed_share(tier, steps=4):
    """The routed FFN's share of a decode step's device time: ``steps``
    ``decode_step_paged`` calls of 8 slots (as ``_decode_step_ms``) under
    one ``torch.profiler`` window, ``moe.dropless_ffn`` (the serving
    routed FFN) inside a ``record_function`` range; a kernel counts as routed where the host
    call that launched it (same correlation id) lies in such a range.
    Returns (routed device ms, all device ms) per step."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import model_zoo, moe
    cfg = tier.cfg
    slots, prompt, page = 8, 16, 16
    npg = (prompt + steps + 2) // page + 1
    block = torch.arange(1, slots * npg + 1, dtype=torch.int32,
                         device="cuda").reshape(slots, npg)
    cache = model_zoo.init_paged_cache(cfg, slots, slots * npg + 1, page,
                                       torch.bfloat16, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(1, cfg.vocab_size, (slots, prompt), generator=gen,
                         device="cuda")
    lg, cache = model_zoo.prefill_paged(
        tier.params, cfg, toks, torch.full((slots,), prompt, device="cuda"),
        torch.arange(slots, device="cuda"), block, cache)
    pos = torch.full((slots,), prompt, device="cuda")
    real = moe.dropless_ffn

    def marked(*a, **k):
        with record_function("routed_ffn"):
            return real(*a, **k)

    moe.dropless_ffn = marked
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(steps):
                lg, cache = model_zoo.decode_step_paged(
                    tier.params, cfg, lg.argmax(-1)[:, None], pos + i, block,
                    cache)
            torch.cuda.synchronize()
    finally:
        moe.dropless_ffn = real
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "t.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("name") == "routed_ffn"
                    and e.get("cat") == "user_annotation")
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    total = routed = 0.0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        total += float(e["dur"])
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        if t is not None and any(a <= t <= b for a, b in ranges):
            routed += float(e["dur"])
    if len(ranges) != steps * cfg.num_layers or not 0 < routed < total:
        raise AssertionError(f"routed FFN ranges {len(ranges)} (want "
                             f"{steps * cfg.num_layers}), routed "
                             f"{routed:.1f} of {total:.1f} us")
    return routed / steps / 1e3, total / steps / 1e3


def moe_full_width_phase():
    """deepseek-moe-16b at its published widths and depth (L: 28 layers,
    d_model 2048, 16 / 16 heads of 128, 64 routed experts of 1,408, top 6,
    2 shared; S: ``s_variant(4)``, 7 layers, 16 experts of 352), random
    float32 params from seed 0, bf16 KV: the drain as ARCH's; the stream
    trace's first ``MOE_REQUESTS`` requests through ``serve_stream`` (chunk
    lane, sharing, decode_block 4) at theta 0.6 and the median, then over
    int8 pools; then the speculative lane (8 S / 8 L slots, verify chunk
    q (8, 4, 16, 128)) at theta 0.6.  Each run: every record completes,
    one host fetch per tick, every kernel's launches as the lane flags
    predict.  Routing drops make stream == drain and sharing on == off
    fail at this width, in the reference too, so they are not asserted.
    Logs per tier the param bytes, the decode step's ms and the routed
    FFN's share of its device time; then the full-width MoE layer's drops,
    card against CPU (:func:`moe_layer_phase`).  Returns the launches of
    the drain, the bf16 and int8 streams and the speculative run, and the
    verify lane's chunk-kernel launches."""
    import torch
    from repro_torch.kernels import ops
    launches, eng, _ = serve_full_width(MOE_ARCH)
    for t, tier in (("L", eng.l), ("S", eng.s)):
        log(f"  {t} tier {tier.cfg.name}: {_param_bytes(tier.params) / 1e9:.2f}"
            f" GB of float32 params, {tier.cfg.num_layers} layers, "
            f"{tier.cfg.num_experts} experts of {tier.cfg.d_ff_expert}, top "
            f"{tier.cfg.experts_per_token}")
    reqs = _stream_trace(eng.l.cfg)[:MOE_REQUESTS]
    ticks0 = eng.stats["stream_ticks"]
    stream, _, out = serve_stream_full_width(eng, STREAM_KW, reqs)
    ticks = eng.stats["stream_ticks"] - ticks0
    log(f"  stream launches per tick (hand-written kernels, both runs): "
        f"{sum(stream.values()) / ticks:.1f} over {ticks} ticks")
    log(f"== serve_stream ({MOE_ARCH}, int8 pools)")
    int8 = int8_stream_phase(eng, STREAM_KW, reqs, out,
                             ("cow", "saved", "chunk"),
                             max_ratio=INT8_MAX_RATIO)
    log(f"== speculative ({MOE_ARCH}: the draft-verify lane)")
    try:
        eng.hi = dataclasses.replace(eng.hi, theta=THETA)
        spec_out, sched, spec, ticks, wall = _counted_run(eng, reqs, SPEC_KW)
    finally:
        eng.hi = dataclasses.replace(eng.hi, theta=THETA)
    _check_spec_outputs(spec_out, reqs, eng.l.cfg)
    verify = sched.lrt.lane_ticks["live"]
    n_l = eng.l.cfg.num_layers
    lane = n_l * sched.lrt.lane_ticks["chunk"] + \
        eng.s.cfg.num_layers * sched.srt.lane_ticks["chunk"]
    if verify == 0 or spec["decode_attention_chunk_paged"] != \
            n_l * verify + lane:
        raise AssertionError("chunk kernel launches != verify ticks x L "
                             "layers + the chunk lanes'")
    st = sched.stats
    log(f"  speculative, theta {THETA}: {wall * 1e3:.1f} ms, {ticks} ticks "
        f"({verify} ran the verify lane), {len(spec_out) / wall:.2f} req/s; "
        f"drafted {st['drafted']}, accepted {st['accepted']}, escalated "
        f"blocks {st['escalated_blocks']}; chunk kernel "
        f"{spec['decode_attention_chunk_paged']} launches = {n_l} x {verify}"
        f" verify ticks + {lane} chunk-lane; "
        f"{sum(spec.values()) / ticks:.1f} launches per tick; one host fetch"
        f" per tick")
    log(f"== routed FFN share and the full-width MoE layer ({MOE_ARCH})")
    for t, tier in (("L", eng.l), ("S", eng.s)):
        routed, total = _routed_share(tier)
        step = _decode_step_ms(tier, torch.bfloat16)
        log(f"  {t} tier decode step (8 slots, bf16 pool): {step:.2f} ms host"
            f" wall; device {total:.2f} ms, of which the routed FFN "
            f"{routed:.2f} ms = {routed / total:.1%}")
    moe_layer_phase(eng)
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak max_memory_allocated over the {MOE_ARCH} phases "
        f"{peak / 2 ** 30:.2f} GiB")
    del eng
    ops.reset_launch_counts()
    return launches, stream, int8, spec, n_l * verify


def moe_layer_phase(eng):
    """Layer 0's routed FFN at the published widths (64 experts of 1,408
    over d_model 2,048, top 6, capacity factor 2.0), on the card and on the
    CPU on the same inputs: the MoE input of a 4-row admission of the 512
    bucket (T = 2,048, cap 384; right-padded with token 0 as the
    batcher pads) and of 4 decode tokens (T = 4, cap 1: the L tier's
    decode, where drops are certain).  Both devices must route alike and
    drop the same (token, choice) pairs, with outputs within
    ``MOE_LAYER_TOL``.  Reports the drop counts, and how many real tokens'
    pairs of the admission drop only because the padded tails (routed
    ahead of later rows' tokens in token order) took their slots."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models.transformer import layer_params
    cfg = eng.l.cfg
    lp = layer_params(eng.l.params["layers"], 0)
    mesh = make_serving_mesh(1, 1)
    lens = MOE_ADMISSION
    rng = np.random.default_rng(9)
    toks = np.zeros((len(lens), 512), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    with torch.no_grad():
        h = eng.l.params["embed"][torch.as_tensor(toks, device="cuda")]
        h = h + L.attention_forward(
            lp["attn"], L.rmsnorm(lp["ln1"], h, cfg.norm_eps),
            num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)
        x = L.rmsnorm(lp["ln2"], h, cfg.norm_eps)
    last = torch.as_tensor([n - 1 for n in lens], device="cuda")
    inputs = {"admission": x,
              "decode": x[torch.arange(len(lens), device="cuda"), last][:, None]}
    cpu_lp = {k: _to(v, "cpu") if isinstance(v, dict) else v.cpu()
              for k, v in lp.items() if k in ("router", "experts")}
    real = torch.as_tensor(toks != 0).reshape(-1)
    for name, xx in inputs.items():
        t = xx.shape[0] * xx.shape[1]
        cap = moe.moe_capacity(t, cfg.num_experts, cfg.experts_per_token,
                               moe.SERVE_CAPACITY)
        res = {}
        for dev, p in (("cuda", lp), ("cpu", cpu_lp)):
            xd = xx.to(dev)
            y, aux = moe.moe_ffn(p, cfg, xd, moe.SERVE_CAPACITY)
            _, idx, _, keep, _ = moe.route(p, cfg, xd.reshape(t, -1), cap)
            res[dev] = (y.cpu(), float(aux), idx.cpu(), keep.cpu())
        (yg, ag, ig, kg), (yc, ac, ic, kc) = res["cuda"], res["cpu"]
        err = float((yg - yc).abs().max())
        drops = int((~kg).sum())
        msg = (f"  MoE layer 0 at full width, {name}: T {t}, cap {cap}; "
               f"choices routed alike on card and CPU: "
               f"{bool(torch.equal(ig, ic))}; dropped (token, choice) pairs "
               f"{drops} of {kg.numel()} (card) / {int((~kc).sum())} (CPU), "
               f"the same set: {bool(torch.equal(kg, kc))}; max output err "
               f"{err:.2e} (tol {MOE_LAYER_TOL:g}); aux {ag:.6f} / {ac:.6f}")
        if name == "admission":
            # the same rows with the padded tails left out, at the same cap
            _, _, _, k_real, _ = moe.route(
                lp, cfg, xx.reshape(t, -1)[real.to("cuda")], cap)
            by_tails = int((~kg[real] & k_real.cpu()).sum())
            msg += (f"; real tokens' pairs dropped {int((~kg[real]).sum())}"
                    f", of which dropped only because the padded tails took "
                    f"their slots: {by_tails}")
        # the expert-parallel dispatch on the (1, 1) mesh: moe_ffn's bits
        ys, auxs = moe.moe_ffn_sharded(lp, cfg, xx, moe.SERVE_CAPACITY, mesh)
        ks = moe.route_local(lp, cfg, xx.reshape(t, -1), cap, 0,
                             cfg.num_experts)[3].cpu()
        sharded_same = (torch.equal(ys.cpu(), yg) and float(auxs) == ag
                        and torch.equal(ks, kg))
        msg += (f"; moe_ffn_sharded on the (1, 1) mesh equals moe_ffn bit "
                f"for bit, the same dropped pairs: {sharded_same}")
        log(msg)
        if not (torch.equal(ig, ic) and torch.equal(kg, kc)
                and err <= MOE_LAYER_TOL and sharded_same) \
                or (name == "decode" and not drops):
            raise AssertionError("the full-width MoE layer: card and CPU "
                                 "disagree, the (1, 1) mesh's dispatch "
                                 "differs, or nothing dropped")


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _check_outputs(out, batch, cfg, theta):
    import numpy as np
    b = batch.tokens.shape[0]
    cap = max(1, min(b, int(round(b * CAPACITY))))
    if out["tokens"].shape != (b, MAX_NEW) or out["confidence"].shape != (b,):
        raise AssertionError(f"output shapes {out['tokens'].shape}")
    if not np.isfinite(out["confidence"]).all() or not (
            (out["confidence"] >= 0) & (out["confidence"] <= 1)).all():
        raise AssertionError("confidence not finite in [0, 1]")
    if not ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all():
        raise AssertionError("token ids out of range")
    if not np.array_equal(out["offloaded"],
                          out["confidence"] < np.float32(theta)):
        raise AssertionError("offload != mean conf < theta")
    remote = out["served_remote"]
    if (remote & ~out["offloaded"]).any() or remote.sum() > cap or \
            remote.sum() != min(int(out["offloaded"].sum()), cap):
        raise AssertionError("router served a wrong set")
    if not np.array_equal(out["tokens"][~remote], out["s_tokens"][~remote]):
        raise AssertionError("local rows lost their S answer")


# ---------------------------------------------------------------------------
# head dim 120: h2o-danube-3-4b (d_model 3,840 over 32 heads of 120, 8 kv
# heads; its S tier 8 over 8)
# ---------------------------------------------------------------------------

def check_d120_kernels(gen):
    """The drain, paged decode and chunk kernels at D = 120 against their
    plain versions, at danube's L and S shapes: the drain's q (B, 1, H, 120)
    over a (B, 1024, 8, 120) bf16 cache, the paged decode kernel and the
    C = 256 chunk over bf16 and int8 pools with garbage planted where no
    query looks; then each kernel twice on the same inputs, the same bits.
    Returns {kernel name: [entry, ...]} for the kernels line."""
    import torch
    from repro_torch.kernels import decode_attention as da
    pos_l, pos_s, _ = _decode_positions()
    c = STREAM_KW["chunk_size"]
    lt, st = f"L tier {DANUBE_ARCH}", f"S tier {DANUBE_ARCH}-s4"
    paged, chunked = "decode_attention_paged", "decode_attention_chunk_paged"
    out = {}

    def put(entry):
        out.setdefault(entry["name"], []).append(entry)

    for shape in ((lt, 4, 32, 8, 120), (st, 8, 8, 8, 120)):
        put(check_decode_attention(gen, (shape,)))
    for quant in (False, True):
        for case in ((lt, 4, 32, 8, 120, L_PAGES, pos_l, NPG, True),
                     (st, 8, 8, 8, 120, S_PAGES, pos_s, NPG, True)):
            put(check_paged(gen, paged, 1, [case], quant=quant))
        for case in ((lt, 2, 32, 8, 120, L_PAGES, [0, 512 - c], NPG, True),
                     (st, 2, 8, 8, 120, S_PAGES, [0, 512 - c], NPG, True)):
            put(check_paged(gen, chunked, c, [case], quant=quant))
    # the same bits twice: the drain and paged decode kernels merge their
    # splits in a fixed order, the chunk kernel has one block per row tile
    kpos = torch.arange(CACHE_LEN, device="cuda")
    drain = _attn_case(gen, 4, 32, 8, 120, CACHE_LEN, kpos <= DECODE_POS,
                       torch.bfloat16)
    runs = [("decode_attention", da.decode_attention_cuda, drain)]
    for quant in (False, True):
        for cc, kern in ((1, da.decode_attention_paged_cuda),
                         (c, da.decode_attention_chunk_paged_cuda)):
            q, pk, pv, block, valid, scales = _paged_case(
                gen, 4 if cc == 1 else 2, 32, 8, L_PAGES,
                pos_l if cc == 1 else [0, 512 - c], cc, 120, NPG, True,
                quant)
            runs.append((kern.__name__ + ("[int8]" if quant else ""), kern,
                         (q, pk, pv, block, valid[:, 0] if cc == 1 else valid,
                          *scales)))
    for name, kern, args in runs:
        one, two = kern(*args), kern(*args)
        torch.cuda.synchronize()
        if not torch.equal(one.view(torch.int32), two.view(torch.int32)):
            raise AssertionError(f"{name} at D 120: two calls differ")
    log(f"  D 120: {', '.join(n for n, _, _ in runs)}: the same bits twice")
    return out


def danube_full_width_phase():
    """h2o-danube-3-4b at its published widths and depth (L 24 layers,
    d_model 3,840, 32 heads over 8 kv heads of 120, sliding window 4,096;
    S ``s_variant(4)``: 6 layers, 8 over 8 heads of 120), random float32
    params from seed 0: the drain as ARCH's, then the stream trace's first
    ``DANUBE_REQUESTS`` requests through ``serve_stream`` at theta 0.6 and
    the median, then over int8 pools; each run one host fetch per serve or
    tick and every kernel's launches as the lane flags predict.  Returns the
    launches of the drain and of the bf16 and int8 streams."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.reset_peak_memory_stats()
    launches, eng, _ = serve_full_width(DANUBE_ARCH)
    for t, tier in (("L", eng.l), ("S", eng.s)):
        log(f"  {t} tier {tier.cfg.name}: {_param_bytes(tier.params) / 1e9:.2f}"
            f" GB of float32 params, {tier.cfg.num_layers} layers, "
            f"{tier.cfg.num_heads} heads over {tier.cfg.num_kv_heads} of "
            f"{tier.cfg.resolved_head_dim}")
    reqs = _stream_trace(eng.l.cfg)[:DANUBE_REQUESTS]
    ticks0 = eng.stats["stream_ticks"]
    stream, _, out = serve_stream_full_width(eng, STREAM_KW, reqs)
    ticks = eng.stats["stream_ticks"] - ticks0
    log(f"  stream launches per tick (hand-written kernels, both runs): "
        f"{sum(stream.values()) / ticks:.1f} over {ticks} ticks")
    log(f"== serve_stream ({DANUBE_ARCH}, int8 pools)")
    int8 = int8_stream_phase(eng, STREAM_KW, reqs, out,
                             ("cow", "saved", "chunk"),
                             max_ratio=INT8_MAX_RATIO)
    log(f"  peak max_memory_allocated over the {DANUBE_ARCH} phases "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del eng
    ops.reset_launch_counts()
    return launches, stream, int8


# ---------------------------------------------------------------------------
# the launch tooling: the dry run, the split cache, the one-step HI case
# ---------------------------------------------------------------------------

_DRYRUN_DRIVER = """
import json, os, signal, sys, time
# its session (this process and its workers) ends with the script, which
# sends SIGTERM when it dies (PR_SET_PDEATHSIG)
signal.signal(signal.SIGTERM, lambda *a: os.killpg(0, signal.SIGKILL))
from repro_torch.launch import dryrun
out, runs = sys.argv[1], json.loads(sys.argv[2])
summary = []
for i, (name, argv, refused) in enumerate(runs):
    t0 = time.perf_counter()
    path = f"{out}/dryrun_{i}.json"
    try:
        dryrun.main(argv + ["--out", path])
    except SystemExit:
        pass
    rows = json.load(open(path))
    summary.append({"run": name, "seconds": time.perf_counter() - t0,
                    "refused": refused, "rows": rows})
print("DRYRUN " + json.dumps(summary))
"""


def _dryrun_runs():
    """(name, argv, the error expected of every case not skipped or None):
    every case at both meshes (``DRYRUN_JOBS`` workers), the split-cache
    decode on each sliding-window arch, and the HI case per arch."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ARCHS
    decode = [s for s, sh in SHAPES.items() if sh.is_decode]
    runs = [("all", ["--all", "--both-meshes", "--jobs", str(DRYRUN_JOBS)],
             None)]
    runs += [(f"split_cache {a} {s}", ["--arch", a, "--shape", s,
                                       "--both-meshes", "--variant",
                                       "split_cache"], None)
             for a, c in ARCHS.items() if c.sliding_window for s in decode]
    runs += [(f"hi {a}", ["--arch", a, "--both-meshes", "--hi"],
              HI_REFUSED.get(a)) for a in ARCHS]
    return runs


def _dryrun_preexec() -> None:
    """In the dry run's process before it starts: a lower priority, and
    SIGTERM when this script's process dies (PR_SET_PDEATHSIG)."""
    import ctypes
    import os
    import signal
    os.nice(10)
    ctypes.CDLL(None).prctl(1, signal.SIGTERM)


class DryRun:
    """The dry run in a subprocess of its own (``mesh_phase`` starts a
    one-rank NCCL group in this process, which the fake world must not
    meet) and its own session, at a lower priority than this process:
    started at once, read by :meth:`finish`, its every process killed by
    :meth:`stop` whatever happens."""

    def __init__(self, keep: Path | None):
        import os
        import tempfile
        self._tmp = tempfile.TemporaryDirectory()
        self.dir = Path(self._tmp.name) if keep is None else keep
        self.dir.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        self.t0 = time.perf_counter()
        # output to files: a pipe that nobody reads until the end would
        # stall the run once full
        self._out = open(self.dir / "dryrun.out", "w+")
        self._err = open(self.dir / "dryrun.err", "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _DRYRUN_DRIVER, str(self.dir),
             json.dumps(_dryrun_runs())], env=env, cwd=str(ROOT),
            stdout=self._out, stderr=self._err, start_new_session=True,
            preexec_fn=_dryrun_preexec)

    def finish(self, timeout: float) -> dict:
        """Wait for the dry run; one line of ok / skipped / errors and
        seconds per run; raises on any error."""
        self.proc.wait(timeout=timeout)
        secs = time.perf_counter() - self.t0
        self._out.seek(0)
        self._err.seek(0)
        out, err = self._out.read(), self._err.read()
        lines = [ln for ln in out.splitlines() if ln.startswith("DRYRUN ")]
        if self.proc.returncode != 0 or not lines:
            raise AssertionError(f"dry run exited {self.proc.returncode}: "
                                 f"{err[-3000:]}")
        summary = json.loads(lines[-1][len("DRYRUN "):])
        n_err = 0
        for run in summary:
            status = [r["status"] for r in run["rows"]]
            refused = run["refused"]
            note = ""
            if refused is None:
                n_err += status.count("error")
            else:
                # the known refusal: every case not skipped raises it
                held = status.count("ok") == 0 and all(
                    refused in r["error"] for r in run["rows"]
                    if r["status"] == "error")
                n_err += 0 if held and "error" in status else 1
                note = f" (the reference's refusal: {refused!r})"
            log(f"  dry run {run['run']}: {status.count('ok')} ok, "
                f"{status.count('skipped')} skipped, "
                f"{status.count('error')} errors of {len(status)} in "
                f"{run['seconds']:.1f} s{note}")
            for r in run["rows"]:
                if r["status"] == "error" and refused is None:
                    log(f"    {r['arch']} x {r['shape']} x {r['mesh']}: "
                        f"{r['error']}")
        log(f"  dry run: {secs:.1f} s since its start")
        if n_err:
            raise AssertionError(f"the dry run reported {n_err} errors")
        return summary

    def stop(self) -> None:
        import os
        import signal
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)   # workers included
        except ProcessLookupError:
            pass
        self.proc.wait()
        self._out.close()
        self._err.close()
        self._tmp.cleanup()


def _tensors_of(tree):
    """The tensors of a nested dict or tuple (the host ints left out)."""
    import torch
    from repro_torch.tree import leaves
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def _same_shapes(real, meta, what):
    got = [(tuple(t.shape), t.dtype) for t in _tensors_of(real)]
    want = [(tuple(t.shape), t.dtype) for t in _tensors_of(meta)]
    if got != want:
        raise AssertionError(f"{what}: the card's tensors are not the dry "
                             "run's")


def split_cache_phase(gen):
    """gemma3-1b at its published widths and depth (26 layers, 22 of them
    windowed at 1,024, 4 global; head dim 256, 4 heads over 1 kv head;
    vocab 262,144), random float32 params from seed 0, at long_500k uncut
    (B 1, S 524,288, bf16 caches).  The uniform cache's rows < SPLIT_POS
    come from a seed; the split cache is built from them (ring slot s
    holds position p_s, the global stacks their layers' rows).  One decode
    step each way from SPLIT_POS: the logits agree within
    SPLIT_LOGIT_TOL, each step launches the drain kernel once a layer,
    counted on each path from 0; both caches' bytes and ms a step each
    way.  Then the drain kernel at the two paths' new shapes against its
    plain version, SDPA and its bound.  Returns (the launches of both
    paths, the kernels line's cases, each path's drain launches)."""
    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import model_zoo, transformer
    cfg = get_arch(SPLIT_ARCH)
    shape = SHAPES["long_500k"]
    b, s, p, w = shape.global_batch, shape.seq_len, SPLIT_POS, \
        cfg.sliding_window
    torch.cuda.reset_peak_memory_stats()
    params = model_zoo.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    uni = model_zoo.init_cache(cfg, b, s, torch.bfloat16, "cuda")
    for key in ("k", "v"):
        for i in range(cfg.num_layers):
            uni[key][i, :, :p] = torch.randn(
                (b, p) + uni[key].shape[3:], generator=gen, device="cuda",
                dtype=torch.bfloat16)
    uni["pos"] = p
    spl = transformer.init_split_cache(cfg, b, s, torch.bfloat16, "cuda")
    ring = L.ring_positions(p - 1, w, "cuda")      # slot -> position held
    li = gi = 0
    for i, local in enumerate(transformer._is_local(cfg)):
        for key in ("k", "v"):
            if local:
                spl[f"local_{key}"][li] = uni[key][i][:, ring]
            else:
                spl[f"global_{key}"][gi] = uni[key][i]
        li, gi = li + local, gi + (not local)
    spl["pos"] = p
    nbytes = {name: sum(t.numel() * t.element_size() for k, t in c.items()
                        if k != "pos") for name, c in (("uniform", uni),
                                                       ("split", spl))}
    token = torch.randint(1, cfg.vocab_size, (b, 1), generator=gen,
                          device="cuda")
    steps = {"uniform": transformer.decode_step,
             "split": transformer.decode_step_split}
    caches = {"uniform": uni, "split": spl}
    logits, runs, launches = {}, {}, {}
    with torch.inference_mode():
        for name, step in steps.items():
            # each path's launches, counted from 0: one checked step, then
            # the timed ones (each rewrites row / slot SPLIT_POS with the
            # same values)
            cache = caches[name]
            ops.reset_launch_counts()
            logits[name], _ = step(params, cfg, token, cache)
            runs[name] = timed(lambda: step(params, cfg, token, cache), [()],
                               SPLIT_STEPS, warmup=2)
            torch.cuda.synchronize()
            launches[name] = ops.launch_counts()
        lu, ls = logits["uniform"], logits["split"]
        err = (lu - ls).abs().max().item()
        if not (err <= SPLIT_LOGIT_TOL and bool(torch.isfinite(lu).all())):
            raise AssertionError(f"split cache: logits differ by {err:.3e}")
    # one launch a layer a step on each path
    steps_run = 1 + 2 + SPLIT_STEPS
    for name, counts in launches.items():
        if counts["decode_attention"] != cfg.num_layers * steps_run:
            raise AssertionError(f"split cache, {name} path: {counts} "
                                 f"launches in {steps_run} steps")
    total = {k: launches["uniform"][k] + launches["split"][k]
             for k in launches["uniform"]}
    # the card's own time a step: one CUDA-graph replay of SPLIT_STEPS
    # steps, no host submission inside (its captures are not launches of
    # the path: the counts above are the kernels line's)
    with torch.inference_mode():
        dev = {name: graph_ms(lambda: step(params, cfg, token,
                                           caches[name]), [()], SPLIT_STEPS)
               for name, step in steps.items()}
    log(f"  {SPLIT_ARCH} long_500k (B {b}, S {s:,}, pos {p:,}): caches "
        f"{nbytes['uniform'] / 1e9:.2f} GB uniform, {nbytes['split'] / 1e9:.2f}"
        f" GB split; logits max |diff| {err:.2e} (tol {SPLIT_LOGIT_TOL:g}); "
        f"{runs['uniform']:.3f} ms a step uniform, {runs['split']:.3f} ms "
        f"split (CUDA events, {SPLIT_STEPS} steps; device {dev['uniform']:.3f}"
        f" / {dev['split']:.3f} ms, a CUDA-graph replay); drain launches "
        f"{launches['uniform']['decode_attention']} uniform, "
        f"{launches['split']['decode_attention']} split in {steps_run} "
        f"steps each; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params, uni, spl, caches
    gc.collect()
    torch.cuda.empty_cache()

    # the drain kernel at the two paths' shapes: the global layers over
    # S = 524,288 (both paths), the uniform cache's windowed layers over
    # the same S, the split cache's ring over W = 1,024.  A path's launches
    # are counted, not a shape's: each case names the paths that run it
    kpos = torch.arange(s, device="cuda")
    upto = kpos <= p
    cases = []
    for label, valid, paths in (
            ("long_500k global", upto, ["uniform", "split"]),
            ("long_500k window 1024", upto & (p - kpos < w), ["uniform"]),
            ("ring of 1024", torch.ones(w, dtype=torch.bool,
                                        device="cuda"), ["split"])):
        entry = drain_case(gen, f"{SPLIT_ARCH} {label}", b, cfg.num_heads,
                           cfg.num_kv_heads, cfg.resolved_head_dim, valid,
                           torch.bfloat16)
        entry["paths"] = paths
        cases.append(entry)
        torch.cuda.empty_cache()
    path_launches = {name: counts["decode_attention"]
                     for name, counts in launches.items()}
    return total, cases, path_launches


def hi_case_phase(gen):
    """The reference's one-step HI serve (``launch/specs.
    make_hi_decode_case``) on full-width qwen2-1.5b at decode_32k's seq_len
    32,768 with the batch cut to HI_BATCH (capacity 16), float32 params
    and bf16 caches (the port's model code's dtypes), decoding at position
    32,767.  The case is built in a (1, 1) dry-run world and counted on
    meta; its arguments are then made on the card from seeds (params by
    ``init_params``, caches and tokens random) and must have the dry run's
    shapes, dtypes and bytes.  One step on the card: the merged rows equal
    the S tier's logits where not served remote and the L tier's where
    served, from separate ``decode_step`` calls on copies of the caches,
    bit for bit; the drain kernel launched once per layer of both tiers;
    the step no faster than the roofline's largest term.  Returns the
    launches."""
    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import router
    from repro_torch.core.confidence import confidence
    from repro_torch.kernels import ops
    from repro_torch.launch import counting
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import dryrun_world, make_serving_mesh
    from repro_torch.models import model_zoo
    cfg = get_arch(HI_ARCH)
    s_cfg = cfg.s_variant(4)
    shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=HI_BATCH)
    theta = 0.607
    with dryrun_world(1):
        fn, args, _, _ = specs.make_hi_decode_case(
            cfg, shape, make_serving_mesh(1, 1, device="cpu"), theta=theta,
            dtype=torch.float32)
        _, counts = counting.count(fn, args)
    roof = rl.Roofline(HI_ARCH, shape.name, "(1, 1)", 1, counts.flops,
                       counts.dot_bytes, sum(counts.collectives.values()),
                       flop_per_s=rl.peak_flops(torch.float32))
    cap = args[4]["k"].shape[1]

    def cache(meta):
        return {k: (v if k == "pos" else torch.randn(
            v.shape, generator=gen, device="cuda", dtype=v.dtype))
            for k, v in meta.items()}

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    real = (model_zoo.init_params(
                torch.Generator(device="cuda").manual_seed(0), s_cfg),
            model_zoo.init_params(
                torch.Generator(device="cuda").manual_seed(1), cfg),
            torch.randint(1, cfg.vocab_size, tuple(args[2].shape),
                          generator=gen, device="cuda",
                          dtype=args[2].dtype),
            cache(args[3]), cache(args[4]))
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - base
    _same_shapes(real, args, "HI case")
    stored = sum(t.untyped_storage().nbytes() for t in _tensors_of(real))
    if stored != counts.argument_bytes:
        raise AssertionError(f"HI case: the card's arguments take {stored} "
                             f"bytes, the dry run's {counts.argument_bytes}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with torch.inference_mode():
        merged, _, _, served = fn(*real)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - base
        step = ops.launch_counts()
        if step["decode_attention"] != s_cfg.num_layers + cfg.num_layers:
            raise AssertionError(f"HI case: {step} launches in a step")
        s_params, l_params, token, s_cache, l_cache = real
        s_ref, _ = model_zoo.decode_step(
            s_params, s_cfg, token, {k: (v if k == "pos" else v.clone())
                                     for k, v in s_cache.items()})
        conf = confidence(s_ref, "max_prob")
        dec = router.route(conf < theta, conf, cap)
        l_ref, _ = model_zoo.decode_step(
            l_params, cfg, token[dec.indices],
            {k: (v if k == "pos" else v.clone()) for k, v in l_cache.items()})
        want = s_ref.clone()
        want[dec.indices[dec.valid]] = l_ref[dec.valid]
        n_served = int(served.sum())
        if not (torch.equal(served, dec.served_remote)
                and torch.equal(merged, want) and 0 < n_served < HI_BATCH):
            raise AssertionError(
                f"HI case: merged rows differ from the tiers' ({n_served} "
                "served remote)")
        ms = timed(fn, [real], HI_STEPS, warmup=2)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        # the card's own time a step: a CUDA-graph replay (its captures are
        # not launches of the path)
        dev_ms = graph_ms(fn, [real], HI_STEPS)
    if min(ms, dev_ms) / 1e3 < roof.bound_s:
        raise AssertionError(f"HI case: {ms:.3f} ms a step (device "
                             f"{dev_ms:.3f}), below the roofline's "
                             f"{roof.bound_s * 1e3:.3f} ms")
    log(f"  HI case {HI_ARCH} decode_32k, batch {HI_BATCH}, capacity {cap}: "
        f"{n_served} served remote, merged rows == the tiers' bit for bit; "
        f"arguments {stored / 1e9:.3f} GB == the dry run's (allocator "
        f"{allocated / 1e9:.3f} GB); peak reckoned "
        f"{counts.peak_bytes / 1e9:.3f} GB, max_memory_allocated rise "
        f"{rise / 1e9:.3f} GB; {ms:.3f} ms a step (CUDA events, {HI_STEPS} "
        f"steps; device {dev_ms:.3f} ms, a CUDA-graph replay), roofline "
        f"{roof.bound_s * 1e3:.3f} ms ({roof.dominant}: c "
        f"{roof.compute_s * 1e3:.3f} m {roof.memory_s * 1e3:.3f} ms), "
        f"{roof.bound_s / (ms / 1e3):.3f} of the step, "
        f"{roof.bound_s / (dev_ms / 1e3):.3f} of its device time")
    del real, merged
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------

def _lm_batch(cfg, b, s, seed=0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)))
             for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["patches"] = torch.as_tensor(rng.normal(
            size=(b, cfg.num_patches, cfg.d_model)), dtype=torch.float32)
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(rng.normal(
            size=(b, cfg.num_audio_frames, cfg.d_model)), dtype=torch.float32)
    return batch


def train_reduced_phase():
    """One train step per arch of the registry, reduced, on the card and on
    the CPU from the same params and batch (TF32 off): the loss and the
    grad norm within ``TRAIN_RTOL``; the updated params within lr of each
    other and all but ``TRAIN_OFF_SHARE`` of them within ``TRAIN_RTOL``
    (Adam's update takes either sign where a gradient is at rounding
    noise).  Then reduced qwen2-1.5b's step on the (1, 1) mesh (data
    parallel over one NCCL rank) against the unmeshed step on the card,
    bit for bit.  Returns the card steps' launches (ssd_chunk, once per
    mamba layer of the SSM and hybrid steps)."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo
    from repro_torch.optim import adamw
    from repro_torch.training import trainer
    from repro_torch.tree import leaves
    tcfg = TrainConfig(bf16_state=False, remat=False, lr=1e-3,
                       warmup_steps=1)
    total = dict.fromkeys(_kernel_names(), 0)
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch].reduced()
        init = model_zoo.init_params(torch.Generator().manual_seed(0), cfg)
        batch = _lm_batch(cfg, 2, 32)
        res = {}
        for dev in ("cuda", "cpu"):
            params = _to(init, dev)
            opt = adamw.init_state(params, tcfg)
            ops.reset_launch_counts()
            params, _, m = trainer.train_step(
                params, opt, {k: v.to(dev) for k, v in batch.items()},
                mcfg=cfg, tcfg=tcfg)
            if dev == "cuda":
                torch.cuda.synchronize()
                _add(total, ops.launch_counts())
                n_ssd = ops.launch_counts()["ssd_chunk"]
            res[dev] = (m, [p.cpu() for p in leaves(params)])
        (mc, pc), (mh, ph) = res["cuda"], res["cpu"]
        errs = {k: abs(float(mc[k]) / float(mh[k]) - 1)
                for k in ("loss", "grad_norm")}
        off = n = 0
        worst = 0.0
        for a, b in zip(pc, ph):
            d = (a - b).abs()
            worst = max(worst, float(d.max()))
            off += int((d > 1e-6 + TRAIN_RTOL * b.abs()).sum())
            n += d.numel()
        msg = (f"  train step {arch} ({cfg.family}, reduced), card vs CPU: "
               f"loss {float(mc['loss']):.5f} rel err {errs['loss']:.1e}, "
               f"grad norm {float(mc['grad_norm']):.4f} rel err "
               f"{errs['grad_norm']:.1e} (tol {TRAIN_RTOL:g}); params off by"
               f" > {TRAIN_RTOL:g} rel: {off} of {n}, worst {worst:.1e} "
               f"(lr {tcfg.lr:g}); ssd_chunk launches {n_ssd}")
        recurrent = cfg.family in ("ssm", "hybrid")
        if not (max(errs.values()) <= TRAIN_RTOL and off <= TRAIN_OFF_SHARE * n
                and worst <= tcfg.lr + 1e-6 and (n_ssd > 0) == recurrent):
            raise AssertionError(msg)
        log(msg)
    from repro_torch.launch.mesh import make_serving_mesh
    cfg = ARCHS[ARCH].reduced()
    init = model_zoo.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {k: v.to("cuda") for k, v in _lm_batch(cfg, 2, 32).items()}
    steps = []
    for mesh in (None, make_serving_mesh(1, 1), None):
        params = _to(init, "cuda")
        opt = adamw.init_state(params, tcfg)
        params, opt, m = trainer.make_train_step(cfg, tcfg, mesh)(
            params, opt, batch)
        steps.append(leaves((params, opt, m)))
    same = [all(torch.equal(a, b) for a, b in zip(steps[0], s))
            for s in steps[1:]]
    log(f"  train step {ARCH} (reduced) on the (1, 1) mesh against the "
        f"unmeshed step: params, moments and metrics equal bit for bit: "
        f"{same[0]} (the unmeshed step twice: {same[1]})")
    if not all(same):
        raise AssertionError("the (1, 1) mesh's train step differs from the "
                             "unmeshed one")
    return total


def train_full_width_phase():
    """``launch/train.run`` at full width on the card: qwen2-1.5b (28
    layers; the dense training forward launches no hand-written kernel:
    the reference's is plain jnp too) and mamba2-370m (48 layers; its
    forward launches ``ssd_chunk`` once a layer a step, under autograd),
    ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens at
    ``TRAIN_LR``, float32 params and moments (the reference's ``run``): the
    loss falls; step ms,
    tokens/s and peak memory logged.  Then mamba2's layer 0 at full width:
    its grads through the kernel against the plain path's.  Returns the
    launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run
    total = dict.fromkeys(_kernel_names(), 0)
    for arch, layers in ((ARCH, 28), (SSM_ARCH, 48)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        losses = run(arch, reduced=False, steps=TRAIN_STEPS,
                     batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                     log_every=TRAIN_STEPS, device="cuda")
        counts = ops.launch_counts()
        _add(total, counts)
        st = run.stats
        peak = torch.cuda.max_memory_allocated()
        want = TRAIN_STEPS * layers if arch == SSM_ARCH else 0
        msg = (f"  train {arch} full width ({layers} layers), {TRAIN_STEPS} "
               f"steps of {TRAIN_BATCH} x {TRAIN_SEQ}: loss "
               f"{' '.join(f'{x:.4f}' for x in losses)}; "
               f"{st['seconds'] / TRAIN_STEPS * 1e3:.1f} ms a step, "
               f"{st['tokens_per_s']:.0f} tokens/s; peak "
               f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; ssd_chunk "
               f"launches {counts['ssd_chunk']} (want {want})")
        if not (losses[-1] < losses[0] and counts["ssd_chunk"] == want
                and sum(counts.values()) == want):
            raise AssertionError(msg)
        log(msg)
    _ssd_layer_grads()
    return total


def _ssd_layer_grads():
    """mamba2-370m's layer 0 at full width (d_model 1,024, 32 heads of 64,
    state 128) on 2 x 512 tokens: the input's and every layer param's grads
    with ``ssd_chunk`` through the kernel (``SSDChunk``) against the same
    block with the plain ``ssd_chunk_ref``, each within ``SSD_GRAD_TOL`` of
    its largest magnitude."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import ops, ssd_scan
    from repro_torch.models import mamba2, model_zoo
    from repro_torch.models.transformer import layer_params
    from repro_torch.tree import leaves, unflatten
    cfg = dataclasses.replace(ARCHS[SSM_ARCH], num_layers=1, vocab_size=512)
    gen = torch.Generator(device="cuda").manual_seed(5)
    lp0 = layer_params(model_zoo.init_params(gen, cfg)["layers"], 0)
    x = torch.randn((2, 512, cfg.d_model), generator=gen, device="cuda")
    cot = torch.randn((2, 512, cfg.d_model), generator=gen, device="cuda")
    grads = {}
    real = ops.ssd_chunk
    for path in ("kernel", "plain"):
        wrt = [t.detach().requires_grad_() for t in leaves(lp0)] + \
            [x.clone().requires_grad_()]
        if path == "plain":
            ops.ssd_chunk = ssd_scan.ssd_chunk_ref
        try:
            before = ssd_scan.ssd_chunk_cuda.launches
            y = mamba2.mamba_block(unflatten(lp0, wrt[:-1]), cfg, wrt[-1])
            n = ssd_scan.ssd_chunk_cuda.launches - before
            torch.autograd.backward(y, cot)
        finally:
            ops.ssd_chunk = real
        if n != (1 if path == "kernel" else 0):
            raise AssertionError(f"{path} path launched ssd_chunk {n} times")
        # the layer's pre-norm scale is applied outside the block
        grads[path] = [w.grad for w in wrt if w.grad is not None]
    torch.cuda.synchronize()
    worst = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(grads["kernel"], grads["plain"]))
    msg = (f"  {SSM_ARCH} layer 0 at full width, 2 x 512 tokens: grads of "
           f"the input and {len(grads['kernel']) - 1} params through the "
           f"ssd_chunk kernel vs the plain path: worst error {worst:.2e} of"
           f" each grad's largest magnitude (tol {SSD_GRAD_TOL:g})")
    if not worst <= SSD_GRAD_TOL:
        raise AssertionError(msg)
    log(msg)


def cnn_train_phase():
    """The paper's two CIFAR tiers trained on the card by ``train_cnn``, at
    ``tests/test_system.py``'s sizes (5,000 images, SML_CIFAR 2 epochs,
    LML_CIFAR 4, batch 128): S worse than L by 0.03 or more and better than
    0.4; theta* by brute force on the S tier's test confidences, then
    ``HICascade`` over the 1,200 test images through the hi_gate kernel
    (one launch), its offload mask and served set equal to the plain
    metric's run; then a checkpoint round trip of both tiers' trained
    params (``checkpoint/io``: bit for bit, the same predictions).  Returns
    the kernel run's launches."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs.base import HIConfig
    from repro_torch.core.calibrate import brute_force_theta
    from repro_torch.core.cascade import classifier_cascade
    from repro_torch.data import images
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    from repro_torch.training.cnn_trainer import (accuracy, predict_logits,
                                                  train_cnn)
    from repro_torch.tree import leaves, tree_map
    x_tr, y_tr = images.make_dataset(5000, seed=0, patch_amp=0.7)
    x_te, y_te = images.make_dataset(1200, seed=5, patch_amp=0.7)
    t = {}
    tiers = {}
    for name, cfg, epochs in (("S", cnn.SML_CIFAR, 2), ("L", cnn.LML_CIFAR, 4)):
        t0 = time.perf_counter()
        tiers[name] = train_cnn(cfg, x_tr, y_tr, epochs=epochs, batch=128,
                                device="cuda")
        torch.cuda.synchronize()
        t[name] = time.perf_counter() - t0
    s_acc = accuracy(tiers["S"], cnn.SML_CIFAR, x_te, y_te)
    l_acc = accuracy(tiers["L"], cnn.LML_CIFAR, x_te, y_te)
    msg = (f"  trained SML_CIFAR (2 epochs) in {t['S']:.2f} s, LML_CIFAR (4 "
           f"epochs) in {t['L']:.2f} s on 5,000 images: test accuracy S "
           f"{s_acc:.4f}, L {l_acc:.4f} (S worse than L by >= 0.03, S > 0.4)")
    if not (l_acc > s_acc + 0.03 and s_acc > 0.4):
        raise AssertionError(msg)
    log(msg)
    s_logits = predict_logits(tiers["S"], cnn.SML_CIFAR, x_te)
    e = np.exp(s_logits - s_logits.max(-1, keepdims=True))
    conf = (e / e.sum(-1, keepdims=True)).max(-1)
    l_ok = predict_logits(tiers["L"], cnn.LML_CIFAR, x_te).argmax(-1) == y_te
    theta, _ = brute_force_theta(conf, s_logits.argmax(-1) == y_te, 0.5,
                                 l_correct=l_ok)
    hi = HIConfig(theta=float(theta), capacity_factor=1.0)
    xs = torch.as_tensor(x_te).cuda()
    outs = {}
    for use_kernel in (True, False):
        casc = classifier_cascade(
            lambda p, x: cnn.apply_cnn(p, cnn.SML_CIFAR, x),
            lambda p, x: cnn.apply_cnn(p, cnn.LML_CIFAR, x), hi,
            use_kernel=use_kernel)
        ops.reset_launch_counts()
        with torch.no_grad():
            out = casc.infer(tiers["S"], tiers["L"], xs)
        torch.cuda.synchronize()
        outs[use_kernel] = ({k: v.cpu().numpy() for k, v in out.items()},
                            ops.launch_counts())
    (ok, launches), (op, plain) = outs[True], outs[False]
    pred = ok["pred"]
    msg = (f"  HICascade (theta* {float(theta):.4f}) over the 1,200 test "
           f"images through hi_gate: {launches['hi_gate']} launch, served "
           f"remote {int(ok['served_remote'].sum())}, accuracy "
           f"{float((pred == y_te).mean()):.4f} (S {s_acc:.4f}, L "
           f"{l_acc:.4f}); offload mask and served set equal to the plain "
           f"metric's")
    if not (launches["hi_gate"] == 1 and sum(plain.values()) == 0
            and np.array_equal(ok["offload_mask"], op["offload_mask"])
            and np.array_equal(ok["served_remote"], op["served_remote"])):
        raise AssertionError(msg)
    log(msg)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ckpt_io.save(tmp, tiers, step=6)
        like = tree_map(torch.zeros_like, tiers)
        back, step = ckpt_io.restore(tmp, like)
        dt = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(leaves(tiers), leaves(back)))
    preds = np.array_equal(predict_logits(back["L"], cnn.LML_CIFAR, x_te),
                           predict_logits(tiers["L"], cnn.LML_CIFAR, x_te))
    n = sum(p.numel() for p in leaves(tiers))
    msg = (f"  checkpoint round trip of both tiers ({n} params, "
           f"{len(leaves(tiers))} leaves) in {dt * 1e3:.1f} ms: step {step}, "
           f"bit for bit {same}, L predictions equal {preds}")
    if not (same and preds and step == 6):
        raise AssertionError(msg)
    log(msg)
    return launches


def examples_phase():
    """The paper's three training applications (``examples/*_torch.py``) on
    the card at their ``--fast`` settings: fault detection (the threshold
    S-ML separates normal from faults, 100%), image classification (the
    Table 1 study: theta*, the cascade through hi_gate, one launch) and the
    dog filter (Table 3).  Returns the launches."""
    import importlib.util
    from repro_torch.kernels import ops
    total = dict.fromkeys(_kernel_names(), 0)
    for name, kw in (("fault_detection", dict(windows_per_state=30,
                                              epochs=6)),
                     ("image_classification_hi", dict(fast=True)),
                     ("dog_filter_hi", dict(fast=True))):
        spec = importlib.util.spec_from_file_location(
            f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = mod.main(device="cuda", **kw)
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        _add(total, counts)
        if name == "fault_detection":
            ok = out["sml_acc"] == 1.0
            what = (f"CNN accuracy {out['cnn_acc']:.4f}, threshold S-ML "
                    f"{out['sml_acc']:.4f}, offload {out['offload_frac']:.4f}")
        elif name == "image_classification_hi":
            ok = counts["hi_gate"] == 1 and 0.0 <= out["theta"] <= 1.0
            rep = out["reports"][2]
            what = (f"S {out['s_acc']:.4f}, L {out['l_acc']:.4f}, theta* "
                    f"{out['theta']:.4f}, HI offloaded {rep.offloaded} of "
                    f"{rep.n}, cost {rep.cost:.1f}; hi_gate launches "
                    f"{counts['hi_gate']}")
        else:
            ok = out["n_dogs"] > 0 and out["tp"] + out["fn"] == out["n_dogs"]
            what = (f"dogs {out['n_dogs']}, offloaded "
                    f"{out['tp'] + out['fp']}, recall {out['accuracy']:.4f}")
        msg = f"  example {name}_torch ({kw}): {dt:.1f} s; {what}"
        if not ok:
            raise AssertionError(msg)
        log(msg)
    return total


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=Path, metavar="DIR",
                    help="keep the traced serves' gzipped Chrome traces in "
                         "DIR")
    ap.add_argument("--dryrun-out", type=Path, metavar="DIR",
                    help="keep the dry run's JSON rows in DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.serving.engine import disable_tf32

    disable_tf32()
    log("== device")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"  {kind} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    log("== build")
    info = build.build_info()
    log(f"  {info.path.name} built in {info.seconds:.1f} s")
    for ln in info.ptxas:
        log(f"  {ln}")

    log("== dry run (started in a subprocess; read at the end)")
    dry = DryRun(args.dryrun_out)
    try:
        return _phases(args, kind, count, smi, dry)
    finally:
        dry.stop()


def _phases(args, kind, count, smi, dry) -> int:
    """Phases 3 onwards (see the module docstring); ``dry`` is the dry
    run started after the build."""
    import torch
    log("== kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_hi_gate(gen), check_decode_attention(gen),
               check_decode_attention_paged(gen),
               check_decode_attention_chunk_paged(gen), check_copy_pages(gen),
               check_ssd_chunk(gen), check_decode_attention_paged_int8(gen),
               check_decode_attention_chunk_paged_int8(gen),
               check_copy_pages(gen, quant=True)]
    verify_cases = check_verify_chunk(gen)
    log(f"== kernels at the MoE shapes ({MOE_ARCH}; {LLAVA_GROUP7})")
    moe_cases = check_moe_kernels(gen)
    log(f"== the routed experts' kernels ({MOE_ARCH}'s L and S tiers)")
    for check in (check_grouped_swiglu, check_route_pairs):
        main, cases = check(gen)
        kernels.append(main)
        moe_cases[main["name"]] = cases
    log(f"== kernels at head dim 120 ({DANUBE_ARCH})")
    d120_cases = check_d120_kernels(gen)
    total = dict.fromkeys(_kernel_names(), 0)   # launches over every path

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # on a card that holds nothing else, before any process group
    log(f"== split-cache decode ({SPLIT_ARCH} at long_500k, uncut)")
    split_launches, split_cases, split_paths = split_cache_phase(gen)
    add(split_launches)
    log(f"== the one-step HI case ({HI_ARCH}, decode_32k at batch "
        f"{HI_BATCH})")
    hi_launches = hi_case_phase(gen)
    add(hi_launches)

    log("== cascade (HICascade over SML_CIFAR / LML_CIFAR, the paper's "
        "replays)")
    cascade_launches, _ = cascade_phase()
    add(cascade_launches)
    torch.cuda.empty_cache()

    # the MoE family on a card that holds nothing else yet (its full-width
    # params take 68.2 GB of the 80), and before the traced phases: after
    # them CUPTI kept only 27 of 50 kernel records in every profiled window
    log(f"== small inputs, card vs CPU ({MOE_ARCH}, {MOE_DENSE_RESIDUAL}; "
        "the VLM, the enc-dec and the new dense configs)")
    for arch in (MOE_ARCH, MOE_DENSE_RESIDUAL):
        check_small_reference(arch)
        check_small_int8_reference(arch)
    check_small_stream_reference(MOE_ARCH)
    check_small_families()
    log(f"== serve (the drain path, {MOE_ARCH} at full width)")
    moe_launches, moe_stream, moe_int8, moe_spec, moe_verify = \
        moe_full_width_phase()
    for counts in (moe_launches, moe_stream, moe_int8, moe_spec):
        add(counts)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"== serve (the drain path, {DANUBE_ARCH} at full width: head dim "
        "120)")
    dan_launches, dan_stream, dan_int8 = danube_full_width_phase()
    for counts in (dan_launches, dan_stream, dan_int8):
        add(counts)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"== serve (the drain path, {ARCH})")
    check_small_reference()
    launches, eng, tokens = serve_full_width()
    add(launches)
    log(f"== serve_stream (the continuous path, {ARCH})")
    check_small_stream_reference()
    check_small_int8_reference()
    stream_launches, stream_reqs, stream_out = serve_stream_full_width(eng)
    add(stream_launches)
    log(f"== trace ({ARCH}: one more serve, and a serve_stream window, under "
        "torch.profiler)")
    # the trace's own first 8 requests, on the scheduler that served it
    trace_phase(eng, tokens, lambda i: _window(stream_reqs), args.trace)
    log(f"== serve_stream ({ARCH}, int8 pools)")
    int8_launches = int8_stream_phase(eng, STREAM_KW, stream_reqs, stream_out,
                                      ("cow", "saved", "chunk"),
                                      max_ratio=INT8_MAX_RATIO)
    add(int8_launches)
    log(f"== faults ({ARCH}: the stream trace under a seeded schedule)")
    fault_launches = fault_stream_phase(eng, stream_reqs, stream_out)
    add(fault_launches)
    log(f"== observability ({ARCH}: telemetry, gate audit, SLO watchdog, "
        "flight recorder)")
    add(observability_phase(eng, stream_reqs, args.trace))
    log(f"== speculative ({ARCH}: the draft-verify lane)")
    spec_launches, *verify_launches = speculative_phase(eng, stream_reqs,
                                                        stream_out)
    add(spec_launches)
    log(f"== legacy ({ARCH}: serve_legacy, the per-token baseline)")
    legacy_launches, _ = legacy_phase(eng)
    add(legacy_launches)
    log(f"== temperature ({ARCH}: sampled serve and serve_stream)")
    check_sampler_bits()
    sampler_step_times()
    temp_launches = temperature_phase(eng, stream_reqs, stream_out)
    add(temp_launches)
    log(f"== mesh ({ARCH}: serve_stream on the (1, 1) mesh, NCCL)")
    mesh_launches = mesh_phase(eng, stream_reqs, stream_out)
    add(mesh_launches)
    del eng
    torch.cuda.empty_cache()

    log(f"== serve (the drain path, {SSM_ARCH})")
    check_small_reference(SSM_ARCH)
    ssm_launches, eng, tokens = serve_full_width(SSM_ARCH)
    add(ssm_launches)
    log(f"== serve_stream ({SSM_ARCH}, chunk lane off)")
    check_small_stream_reference(SSM_ARCH)
    ssm_stream, _, _ = serve_stream_full_width(
        eng, SSM_STREAM_KW, need=("saved", "restore"))
    add(ssm_stream)
    log(f"== trace ({SSM_ARCH}: one more serve, and a serve_stream window, "
        "under torch.profiler)")
    # fresh prompts in each call: the SSM shares whole prompts only, so the
    # trace's own (or a repeated window) would all restore and skip prefill
    trace_phase(eng, tokens,
                lambda i: _window(_stream_trace(eng.l.cfg, seed=1 + i)),
                args.trace, SSM_STREAM_KW, SSM_ARCH)
    del eng
    torch.cuda.empty_cache()
    log(f"== chunk lane ({SSM_ARCH} widths, {CHUNK_DEPTH} layers)")
    add(chunk_lane_phase())
    torch.cuda.empty_cache()
    log(f"== speculative ({SSM_ARCH} widths, {CHUNK_DEPTH} layers)")
    ssm_spec = ssm_speculative_phase()
    add(ssm_spec)
    torch.cuda.empty_cache()

    log(f"== serve_stream ({HYBRID_ARCH} widths, {HYBRID_DEPTH} layers)")
    check_small_reference(HYBRID_ARCH)
    check_small_stream_reference(HYBRID_ARCH)
    check_small_int8_reference(HYBRID_ARCH)
    hybrid_launches, hybrid_int8 = hybrid_stream_phase()
    add(hybrid_launches)
    add(hybrid_int8)
    log(f"== int8 fidelity gate (reduced {HYBRID_ARCH})")
    int8_gate_phase()
    gc.collect()
    torch.cuda.empty_cache()
    log("== training (a reduced step per arch, card vs CPU)")
    train_reduced = train_reduced_phase()
    add(train_reduced)
    log(f"== training at full width ({ARCH}, {SSM_ARCH})")
    train_full = train_full_width_phase()
    add(train_full)
    log("== training the paper's CIFAR tiers (SML_CIFAR, LML_CIFAR), their "
        "cascade and a checkpoint")
    cnn_launches = cnn_train_phase()
    add(cnn_launches)
    log("== the paper's training examples (--fast)")
    example_launches = examples_phase()
    add(example_launches)
    for path, counts, names in (
            (SSM_ARCH, ssm_launches, ("ssd_chunk",)),
            (f"{SSM_ARCH} stream", ssm_stream, ("ssd_chunk",)),
            (HYBRID_ARCH, hybrid_launches,
             ("ssd_chunk", "decode_attention_paged", "copy_pages")),
            (f"{ARCH} int8", int8_launches,
             ("decode_attention_paged[int8]",
              "decode_attention_chunk_paged[int8]", "copy_pages[int8]")),
            (f"{HYBRID_ARCH} int8", hybrid_int8,
             ("ssd_chunk", "decode_attention_paged[int8]",
              "copy_pages[int8]")),
            (f"{ARCH} faults", fault_launches,
             ("hi_gate", "decode_attention_paged",
              "decode_attention_chunk_paged")),
            (f"{ARCH} speculative", spec_launches,
             ("hi_gate", "decode_attention_paged",
              "decode_attention_chunk_paged")),
            (f"{SSM_ARCH} speculative", ssm_spec, ("hi_gate", "ssd_chunk")),
            ("SML_CIFAR cascade", cascade_launches, ("hi_gate",)),
            (f"{ARCH} legacy", legacy_launches, ("decode_attention",)),
            (f"{ARCH} mesh", mesh_launches,
             ("hi_gate", "decode_attention_paged",
              "decode_attention_chunk_paged", "copy_pages",
              "decode_attention_paged[int8]",
              "decode_attention_chunk_paged[int8]", "copy_pages[int8]")),
            (f"{ARCH} sampled", temp_launches,
             ("hi_gate", "decode_attention", "decode_attention_paged",
              "decode_attention_chunk_paged")),
            (MOE_ARCH, moe_launches, ("hi_gate", "decode_attention",
                                      "grouped_swiglu", "route_pairs")),
            (f"{MOE_ARCH} stream", moe_stream,
             ("hi_gate", "decode_attention_paged",
              "decode_attention_chunk_paged", "copy_pages",
              "grouped_swiglu", "route_pairs")),
            (f"{MOE_ARCH} int8", moe_int8,
             ("hi_gate", "decode_attention_paged[int8]",
              "decode_attention_chunk_paged[int8]", "copy_pages[int8]",
              "grouped_swiglu", "route_pairs")),
            (f"{MOE_ARCH} speculative", moe_spec,
             ("hi_gate", "decode_attention_paged",
              "decode_attention_chunk_paged", "grouped_swiglu",
              "route_pairs")),
            (DANUBE_ARCH, dan_launches, ("hi_gate", "decode_attention")),
            (f"{DANUBE_ARCH} stream", dan_stream,
             ("hi_gate", "decode_attention_paged",
              "decode_attention_chunk_paged", "copy_pages")),
            (f"{DANUBE_ARCH} int8", dan_int8,
             ("hi_gate", "decode_attention_paged[int8]",
              "decode_attention_chunk_paged[int8]", "copy_pages[int8]")),
            (f"{SPLIT_ARCH} split cache", split_launches,
             ("decode_attention",)),
            (f"{HI_ARCH} HI case", hi_launches, ("decode_attention",)),
            ("reduced training", train_reduced, ("ssd_chunk",)),
            (f"{SSM_ARCH} training", train_full, ("ssd_chunk",)),
            ("CIFAR cascade after training", cnn_launches, ("hi_gate",)),
            ("training examples", example_launches, ("hi_gate",))):
        for n in names:
            if counts[n] == 0:
                raise AssertionError(f"{n} never launched on the {path} path")
    log(f"  launches over every main-path run: {total}")
    for k in kernels:
        k["launches"] = total[k["name"]]
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on its path")
    # hi_gate's entry carries the cascade shape's cases: one launch a batch
    # (max_prob, the cascade's metric; entropy is timed beside it)
    for case in kernels[0]["cascade"]:
        case["launches"] = (cascade_launches["hi_gate"]
                            if case["shape"].endswith("max_prob") else 0)
    kernels[1]["legacy_launches"] = legacy_launches["decode_attention"]
    # the mesh path's share of each kernel's launches
    for k in kernels:
        k["mesh_launches"] = mesh_launches.get(k["name"], 0)
    # the chunk kernel's entries carry the verify shape's case beside their
    # own: its launches are one per L layer and verify tick
    for case, n in zip(verify_cases, verify_launches):
        entry = next(k for k in kernels if k["name"] == case["name"])
        case["launches"] = n
        entry["verify"] = {k: case[k] for k in (
            "shape", "launches", "max_abs_err", "ms", "device_ms",
            "graph_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "gather_sdpa_ms")}
        entry["max_abs_err"] = max(entry["max_abs_err"], case["max_abs_err"])

    # each kernel's entry carries its cases at the MoE shapes, with the
    # launches of the deepseek-moe-16b runs (the verify shape's: its verify
    # ticks; llava's group 7 and the int8 verify case are timed only)
    moe_total = {}
    for counts in (moe_launches, moe_stream, moe_int8, moe_spec):
        _add(moe_total, counts)
    for k in kernels:
        for case in moe_cases.get(k["name"], []):
            shape = case["shape"]
            case["launches"] = (0 if shape.startswith(LLAVA_GROUP7)
                                or (shape.startswith("L verify")
                                    and k["name"].endswith("[int8]"))
                                else moe_verify if shape.startswith(
                                    "L verify")
                                else moe_total[k["name"]])
            k.setdefault("moe", []).append(
                {key: v for key, v in case.items()
                 if key not in ("name", "route", "source", "replaces")})
            k["max_abs_err"] = max(k["max_abs_err"], case["max_abs_err"])

    # and its cases at head dim 120, with the launches of the danube runs
    dan_total = {}
    for counts in (dan_launches, dan_stream, dan_int8):
        _add(dan_total, counts)
    for k in kernels:
        for case in d120_cases.get(k["name"], []):
            case["launches"] = dan_total[k["name"]]
            k.setdefault("danube", []).append(
                {key: v for key, v in case.items()
                 if key not in ("name", "route", "source", "replaces")})
            k["max_abs_err"] = max(k["max_abs_err"], case["max_abs_err"])

    # the drain kernel's cases at the split cache's shapes, with each path's
    # launches; the HI case's launches
    drain = kernels[1]
    drain["split_cache_launches"] = split_paths
    drain["split_cache"] = [{key: v for key, v in case.items()
                             if key not in ("name", "route", "source",
                                            "replaces")}
                            for case in split_cases]
    drain["max_abs_err"] = max([drain["max_abs_err"]]
                               + [c["max_abs_err"] for c in split_cases])
    drain["hi_case_launches"] = hi_launches["decode_attention"]

    log("== dry run (the subprocess started after the build)")
    dry.finish(timeout=max(60.0, 1100.0 - (time.perf_counter() - T0)))

    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
