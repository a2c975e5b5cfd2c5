#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`kungfu_tpu_torch`) on one card.

    python3 chip_smoke.py

Builds every CUDA kernel of the serving, training and roofline paths
from the sources in this checkout (nvcc, sm_90a; one nvcc per library,
all four started together, beside libkf's g++ build), then runs,
failing on the first phase that fails:

1. kernel — K3 (`paged_attn.resident`, `paged_attn.stream`) against its
   plain PyTorch version at the serving shapes (B=8, h=12, d=64, bt=16,
   max_blocks=64, a 12-layer pool viewed through block_base) in bf16
   and f32, and a second launch bitwise equal to the first;
2. kernel-K2 — the four fused head+CE kernels (`fused_ce.fwd` with and
   without the residual, `fused_ce.residual_d`, `fused_ce.dw`,
   `fused_ce.dx`) against their plain versions at the GPT-2-small
   training shape (N = 8 x 1023 rows, H=768, V=50257, padded to the
   port's tiles), with rows whose target is -1 and rows whose target
   is >= v_pad; loss, lse, tl, logits, d, db, dW and dx;
2b. kernel-K1 — the three flash-attention kernels (`flash.fwd`,
   `flash.dq`, `flash.dkv`) on bf16 inputs against their plain versions
   run in f32 on the same values: o, lse, delta, dq, dk and dv at (a)
   the training shape B=8, T=1024, h=12, d=64, causal; (b) B=2, T=4096,
   causal, window 512; (c) B=2, T=1024, non-causal, d=128; (d) the ring
   hop's contract: the global (o, lse) of a causal 2048-token sequence,
   and `flash_bwd` of its second-half queries against each half of the
   keys;
2c. kernel-R1 — the HBM streaming probe (`stream.neg`, ``o = -x`` in
   bf16) bitwise against its plain version, torch.neg: at the bandwidth
   suite's shape [262144, 1024] (0.5 GiB), a ragged row count, the
   lengths at the edges of its plan (below one vector, one chunk +- 8,
   the grid's chunks +- 1, an odd length: the tail path), a tensor of
   +-0, +-inf, NaNs of both signs, denormals and +-max, and all 65536
   bf16 bit patterns; a second launch bitwise equal to the first;
3. serve — GPT-2-small at full width (bf16, random weights from a
   seed) behind `DecodeEngine` (max_batch 8, bt 16, max_len 1024,
   prefix sharing, 256-token prefill chunks) answering 12 requests;
   driven once with the default kernel ("auto", the plan's resident
   scheme) and once with kernel="stream", the launch counts zeroed just
   before each run and read just after;
4. parity — a 2-layer f32 model at GPT-2-small width: the engine's
   kernel paths give the same tokens as its functional oracle and as
   dense-cache `gpt_generate`;
5. train — `benchmarks.lm.measure_lm_rate` on GPT-2-small at full
   width and depth (f32 master weights, bf16 compute, batch 8, seq
   1024), once with the residual fused-CE backward and once with the
   recompute one, the K2 launch counts zeroed just before each run and
   read just after; the loss must be finite and fall (the batch is the
   same every step); then a third time with attention="flash" (residual
   CE), where K1 must launch 12 times a step per kernel and its plain
   versions never;
5b. resnet — `bench.py`'s headline through the port's entry point,
   `benchmarks.throughput.measure_rate("resnet50", 1)`: ResNet-50 v1.5
   at full size (space-to-depth stem, bf16 compute over f32 parameters
   and BatchNorm statistics, batch 128 at 224x224, synthetic data),
   sync_sgd(SGD(0.1, momentum 0.9)) under a one-rank NCCL group, 3
   warmup and 20 timed steps; the loss must be finite and fall, the
   BatchNorm running statistics finite and moved, and sync_sgd must
   have issued its 161 gradient all-reduces a step; the group is gone
   after it;
5c. roofline — `benchmarks.roofline.roofline_report`, `main`'s path:
   the bandwidth suite (f32 add, bf16 add, bf16 neg, R1) over 0.5 GiB
   beside the card's 3.35 TB/s, and the ResNet-50 step; R1 must have
   launched, its plain version never (R1's launch count is zeroed just
   before and read just after);
7. elastic — runs after 5c and before the timing of 6: the elastic
   training worker path through the port's harness
   (`elastic.harness`): a config server, ``kfrun -w``
   (`python -m kungfu_tpu_torch.run`) and continuity workers
   (`elastic.continuity_worker --model gpt`) sharing the card, each
   training GPT-2-small at full width and depth (batch 8 x 1024,
   flash attention, residual fused CE, AdamW, f32 master weights, bf16
   compute). (a) schedule 3:1,6:2,1:1 over 10 steps, the gradients
   fused into one f32 buffer and summed by libkf (the lump): grow
   1 -> 2 (the joiner proves the broadcast parameters and AdamW state
   beat its fresh init), then shrink to 1 with an eviction; (b) two
   workers, rank 1 killed by a chaos fault after step 3 of 8: the
   survivor recovers (every KF_MTTR phase), trains on, and the schedule
   grows a replacement joiner back; (c) (a)'s schedule on the bucketed
   wire (`grad_pipeline`, KF_GRAD_BUCKET_MB=1), ``none``, then ``bf16``
   on a 7-step cut of it (2:1,4:2,1:1);
   (d) `run_checkpoint_restore` on the bf16 bucketed wire: async sharded
   checkpoints every 2 steps at np 2, the whole cluster SIGKILLed at step
   5, a cold boot at np 1 restores the latest complete generation
   (residual sidecars included) and must beat its fresh init; (e) the
   GNS loop: `elastic.gns_worker`s on the card grow 2 -> 4 because the
   noise-scale monitor asked for it. The grows of (a) and (c) must
   activate their joiner from the runner's warm pool (``KF_JOINER_BOOT
   ... warm=1``, every thread at the runner's niceness; its build split
   into the card's context, the model and the optimizer's state). Every
   continuity, recovery and
   restore marker must show, a parameter digest must be agreed after
   every resync, and each worker's flash and fused-CE kernels must have
   launched, their plain versions never. Prints, per cluster size, rank
   0's median step wall, compute, wire and staging ms (on the bucketed
   wire also the exposed wire, pack, host, land, payload, buckets and
   arrival lag) beside (a)'s, rank 0's device idle share over three
   profiled size-2 steps of (a) and (c), each resync's ms and bytes, the
   KF_MTTR phases, the checkpoint's generation bytes, stall, snapshot
   memory, writer and restore times, the GNS readings, and each
   worker's peak memory, beside the card;
8. adaptive — runs after 7: KungFu's adaptive optimizers. (a) In
   process, under a one-rank NCCL group (joined and left as 5b's):
   GPT-2-small at full width (batch 8 x 1024, flash, residual CE,
   `lm_adamw`) takes 3 steps under the plain inner optimizer, then 3
   from the same seed under each of `sma`, `pair_averaging` and
   `ada_sgd` (the switch at step 2, `broadcast_params` there): at one
   rank the mean of a parameter is itself and each blend adds 0, so
   every wrapper's parameters must `torch.equal` the inner's; K1 and
   K2 must launch 12 and 1 times a step and their plain versions never;
   prints each wrapper's ms/step beside the inner's and its collectives
   a step (one a parameter for `sma` and `ada_sgd`). (b)
   `benchmarks.straggler.measure` at ``--model gpt``, np 2 on the card
   over libkf, one clean cell each for ``sma`` and ``pair`` (2 warm-up,
   6 timed steps): each worker's K1/K2 launched and their plain
   versions never, its loss fell, and ``pair`` mixed in at least one
   round; prints each worker's samples/s and tokens/s, the step's
   split (compute and wire, or the pair store's wait, blend, save and
   request), peak memory and its parameters' gap to the ranks' mean.
   (c) The reference test's straggler contrast at its own model (the
   SLP) on the card: np 4, rank 0 sleeping 120 ms a step, 20 steps of
   64, ``sync`` and ``pair``, clean and with the straggler: prints the
   retentions and checks the reference's ordering, pair's straggler
   rate above 1.5x sync's;
9. serve-tier — runs after 8 and before the timing of 6: the kfserve
   tier through the serve benchmark's cell
   (`benchmarks.serve.measure_cell` over `serve.harness.run_serve_cluster`):
   a config server holding the request ledger, ``kfrun -w`` and
   `serve.worker` replicas sharing the card, each serving GPT-2-small at
   full width and depth in bf16 (max_len 1024, batch 8, 256-token
   prefill chunks, prefix sharing; the same seeded weights as phase 3)
   through `DecodeEngine`, so every decode step launches K3. The
   requests are phase 3's 12 and `default_requests(12, gen_len=64)`,
   after 2 warm-up requests. (a) np 1 with KF_SERVE_KERNEL=auto (the
   plan's resident scheme) and np 2 with ``stream``: each worker's
   scheme launched and K3's plain version never; prints p50/p99 latency,
   generated tokens/s, each worker's decode, prefill, control, resize
   and warm ms and peak memory, and the tier's token agreement with phase 3's
   engine on its 12 requests (printed, not checked: bf16 under other
   batch compositions); (b) np 2 grown to 3 through /addworker once the
   first measured request is done, with 60 more requests, at the
   ledger's default lease: the joiner is activated from the runner's
   warm pool (``KF_SERVE_JOINER ... warm=1``, every thread at the
   runner's niceness), adopts the weights and decodes, the survivors
   ride the epoch switch; then the same grow with ``KF_PREWARM=0`` (the
   joiner starts cold, ``warm=0``). In both runs more requests are
   leased twice than their workers released only if a worker's gap
   between lease renewals (``renew_gap_ms``) outlasted the lease; prints
   each run's re-leased count, stall, renewal gaps and p99 through the
   resize and the two joiners' boot phases side by side; (c) (b)'s
   tier with the ledger on an in-process `ReplicaTier(n=3, wal_dir)`
   and every request admitted
   through a `Router`, rank 1 SIGKILLed at its 20th decode iteration
   with KF_RECOVER=1: the survivor recovers, the dead worker's requests
   are re-leased and every request completes. Every run must complete
   every request with the ledger's invariants empty;
10. scenario — runs after 9 and before the timing of 6: the scenario
   engine (`scenario.run_scenario`). (a) `spot_preempt` at np0 2 with
   GPT-2-small continuity workers sharing the card (batch 8 x 1024,
   flash attention, residual fused CE, AdamW, f32 master weights, bf16
   compute): the whole allocation SIGKILLed at step 8 after async
   checkpoints every 3 steps (one generation in flight), a second launch
   restoring from them; the
   trace decomposed by ``python -m kungfu_tpu_torch.trace --goodput``
   must hold the reference test's checks (invariant within 5 %,
   restored step < 8, each rank >= 8 - restored lost steps, >= 24
   useful step-ranks), and the relaunch's workers must have launched K1
   and K2, their plain versions never; prints the goodput ratio, the
   phase shares and the relaunch gap. (b) `spot_serve_kill` at np0 2
   through the decode tier (GPT-2-small bf16, phase 3's seeded weights,
   serve-tier's settings at the scenario's batch 4 and 3 s lease): rank
   1 SIGKILLed at its 8th iteration, its requests re-leased, the tier
   re-grown; every request done, the ledger's invariants empty, the
   fault fired, K3's resident scheme (the plan's) launched in the
   workers and its plain version never; prints p50/p99 and the
   re-leased count;
11. benchmarks — runs after 10 and before the timing of 6: the port's
   benchmark entry points on the card. (a)
   `benchmarks.lm.measure_decode_rate("small", 8, 128, 128, iters=3)`
   (GPT-2-small bf16, dense-cache `gpt_generate`): tok/s and ms/token;
   the warm-up call's tokens must equal the last timed call's. (b)
   `benchmarks.flash_eff.measure_paged_bandwidth()` (K3 at B=8, max_len
   2048, bt 16, h 12, d 64, bf16, ragged lengths): K3's counts zeroed
   just before and read just after — the plan's scheme launched once a
   call, the plain version never — and one launch on the same inputs
   within ``TOL["bfloat16"]`` of the plain version; prints decode ms,
   its byte bound, GB/s and its share of 3.35 TB/s, and the visited
   fraction of the pool. (c)
   `benchmarks.throughput.measure_adamw_update("small", v)` for
   per-leaf, grouped (`optimizers.group_small_leaves`) and flat
   (`optimizers.flatten_optimizer`) AdamW: ms/step beside the 28 B a
   parameter floor at 3.35 TB/s; the three variants' parameters must be
   bitwise equal after the same steps;
12. zoo — runs after 11 and before the timing of 6: the rest of the
   training surface, which launches no kernel of the port (convolutions,
   BatchNorm, cuBLAS products and plain attention). (a)
   `benchmarks.throughput.measure_rate("vgg16", 1)` at full size (224,
   batch 64, bf16 over f32 parameters, one-rank NCCL group, 2 warmup
   and 8 timed steps): the loss finite and falling, and sync_sgd's
   gradient all-reduces a step equal to the length of
   `fake_model_catalog("vgg16-imagenet")` (32); (b) the same for
   InceptionV3 at 299, batch 64, with the BatchNorm running statistics
   finite and moved and the catalog's 284 all-reduces; (c)
   `benchmarks.publish.run_bert_sma_gns` at BERT-base (L12/H768/12
   heads/vocab 30522, seq 128, batch 16), SMA with and without the GNS
   monitor, its row published into a temporary directory: both losses
   finite; prints both ms a step and the overhead; (d)
   `benchmarks.convergence_cv.run_cifar` on the synthetic CIFAR path
   for `ZOO_CIFAR_STEPS` steps: ``real_data`` false, a finite accuracy;
   (e) the helpers: `data.prefetch_to_device` feeds seeded ImageNet
   batches (`datasets.imagenet.synthetic_batches`, (a)'s shape) to
   VGG16's train step — each batch equal to its plain copy, the copies
   on a side stream; `checkpoint.DCPCheckpointManager` saves (c)'s
   BERT-base state asynchronously and restores it onto the card bitwise
   equal; `dryrun.dryrun(1)` takes one ResNet-18 S-SGD step. Every row
   is printed beside the card;
13. seq — runs after 12 and before the timing of 6: the sequence axis
   on four rank processes sharing the card, joined over gloo (one card
   holds one NCCL rank; the axis collectives stage the card's tensors
   through pinned host memory), through `parallel.long_context.run`:
   (a) GPT-2-small (f32 master weights, bf16 compute, the benchmark's
   AdamW) with `attention="ring"`, `use_flash=True` on a (data 1, seq 4)
   mesh, global T = 4096 (1024 a rank), batch 2, 3 steps; (b) the same
   with `attention="ulysses"` (3 heads a rank, K1 over all 4096
   positions); (c) BERT-base with the ring mixer on a (data 2, seq 2)
   mesh, T = 512, batch 4, 2 steps (non-causal hops). Every rank's loss
   finite, falling and equal to the others'; every rank launched K1's
   fwd, dq and dkv `seq_k1` times a step (a layer a visible hop, or a
   layer) and no plain version; step 1's loss and a sample of its
   averaged gradients against one process on the whole batch: GPT's
   against `attention="flash"` at T = 4096 (within twice the gap between
   that run and the plain mixer's, or the floors `SEQ_LOSS_FLOOR` /
   `SEQ_GRAD_FLOOR`), BERT's against its local mixer (within twice the
   gap between that run in bf16 and in f32, or the same floors). Prints each rank's ms/step and tokens/s (marked:
   4 ranks share one card), the exchange's ms, bytes and staged bytes a
   step, and K1's launches. (d) K1's new cases against their plain
   versions: f32 at d 8..128 and bf16 at d 1..256 (`K1_NEW`), causal,
   non-causal and windowed, the padded wgmma kernels (bf16 off 64/128,
   padded by TMA to D 64, 128 or 256; at d % 8 != 0 through a
   zero-padded copy first) within `kernel_error_bounds`, every f32
   kernel (the tf32 fwd, dq and dkv at d % 4 == 0 up to 64, SIMT at d
   128) within TOL, every case bitwise on a second launch, and one
   launch of B*H = 66000 > 65535. (e)
   `measure_lm_rate("tiny", attention="flash")`: the d-16 GPT trains
   through the padded wgmma fwd, dq and dkv (no SIMT launch); (e')
   `measure_flash_efficiency(dtype="float32")` at its default shape
   through the tf32 fwd, dq and dkv (split TF32 on the tensor cores), no
   SIMT launch; (e'') `measure_flash_efficiency` in bf16 at head dim 256
   (Gemma's) through the D-256 wgmma fwd, dq and dkv; (e''') the same at
   head dim 252 (d % 8 != 0) through the same kernels on a zero-padded
   copy; neither launches the SIMT family; (e'''') the f32 benchmark at
   head dim 128 through the SIMT fwd, dq and dkv, no tf32 launch. (f)
   `dryrun.dryrun(4, "cuda", phases=(2,))`: the dry run's phase 2 (f32
   BERT, d 8, the plain ring as the reference's) on the card's ranks;
6. timing — each K3 scheme per launch at B=8 full 1023-token rows and
   at the serve run's mixed lengths (32..576), cycling through the 12
   layers' pools, and each K2 kernel per launch at the training shape,
   beside its bound, its plain version and the library calls that do
   the same work (scaled_dot_product_attention on pre-gathered K/V for
   K3, with and without the mask, with the backend it took; the cuBLAS
   products inside each K2 kernel; timed here only — the port never
   calls them); and each K1 kernel per launch at shapes (a) and (b) by
   device time, cycling over four input sets so L2 holds none of a
   launch's inputs, beside its bound, its plain version and
   scaled_dot_product_attention's forward and its backward alone (the
   one call that computes dq, dk and dv: the library time of the pair
   dq + dkv), with the backends SDPA picks and each one's time when
   forced; and R1 per
   launch at [262144, 1024] by device time (and by events) beside its
   byte bound and torch.neg (its plain version and the library call at
   once), timed the same way; and K1 off bf16 d 64/128 (f32 at d 64 and
   128, bf16 at d 16, 256 and 252) per launch at `K1_SIMT_TIMING`'s
   shapes, the main path's (e), (e'), (e''), (e''') and (e''''), first
   held there to its plain
   version within TOL (a bf16 kernel within `kernel_error_bounds`),
   beside its bound at the peak of its input type (f32: the lesser of
   FMA at the f32 rate and three tf32 products at the tf32 rate; and the
   exponentials at the special-function rate), its plain version and
   SDPA, with SDPA's own largest error against the plain forward.

Prints the card's name and power limit, the measurements, a
``{"kernels": [...]}`` line (K1's and K2's rows also carry
``elastic_launches``, the elastic workers' launches, and
``seq_launches``, the seq phase's ranks', and
``adaptive_launches``, the adaptive phase's: (a)'s in process and
(b)'s workers; K3's rows carry ``serve_tier_launches``, the serve
tier's workers' launches of that scheme, and ``benchmarks_launches``,
the paged measurement's; the K1, K2 and K3 rows carry
``scenario_launches``, the scenario phase's workers') and, last,
``{"ok": true, "device": ...}``.
Exits non-zero without that line when there is no CUDA card or the
package is missing. Takes no arguments: every phase runs every time.
It caches compiled bytecode under ``build/pycache`` for itself and the
processes it starts (`bytecode_cache`), and names its card in
``CUDA_VISIBLE_DEVICES`` for the runners it starts.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

#: the H100 SXM's published peaks (NVIDIA data sheet): HBM3 bytes/s,
#: f32 FLOP/s outside the tensor cores (K3's arithmetic, K2's
#: elementwise work) and dense bf16 tensor-core FLOP/s (K2's products)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
#: dense TF32 tensor-core FLOP/s (the same data sheet): the rate of each
#: of split TF32's three products (K1's f32 fwd, dq and dkv)
PEAK_TF32_FLOPS = 495e12
#: the H100 SXM's special-function results a second (exp2 and the like),
#: the FlashAttention-3 paper's figure (Shah et al., 2024) beside the
#: 989 TFLOP/s of bf16
PEAK_EXP_S = 3.9e12

BT, HEADS, HEAD_DIM, BATCH, MAX_LEN = 16, 12, 64, 8, 1024
MAX_BLOCKS = MAX_LEN // BT
LAYERS = 12
DEVICE = "cuda"
#: (atol, rtol). bf16: both sides round an f32 result once, so they may
#: differ by one bf16 ulp, at most 2**-7 = 7.8e-3 of |ref|; atol 1e-3
#: only covers values near zero. f32: the same arithmetic in another
#: summation order.
TOL = {"bfloat16": (1e-3, 8e-3), "float32": (1e-5, 1e-5)}
REPLACES = {"resident": "kungfu_tpu/ops/paged_attn.py:158",
            "stream": "kungfu_tpu/ops/paged_attn.py:195"}

#: the GPT-2-small training shape of the fused head: B=8 x (T-1)=1023
#: rows, H=768, V=50257
K2_N, K2_H, K2_V = 8 * 1023, 768, 50257
K2_REPLACES = {"fwd": "kungfu_tpu/ops/fused_ce.py:145",
               "residual_d": "kungfu_tpu/ops/fused_ce.py:189",
               "dw": "kungfu_tpu/ops/fused_ce.py:240",
               "dx": "kungfu_tpu/ops/fused_ce.py:267"}
#: K2 tolerances. f32 outputs (lse, tl, db, the loss): sums of the same
#: f32 terms in another order — rtol 1e-5, atol 1e-5 * max|ref|. bf16
#: outputs of short sums (logits: 768 terms; d: one value): both sides
#: round an f32 value once, and sums in different orders may straddle a
#: rounding boundary, so an element may differ by one bf16 ulp (<= 2**-7
#: * |ref|): 99.9 % of elements within that, every element within
#: 2**-7 * max|ref|. dW and dx sum n = 8192 (dW) or 50304 (dx) products
#: with heavy cancellation (the one-hot term against the softmax mass),
#: where the order of an f32 sum moves a small result by more than an
#: ulp: every element within one ulp of |ref| plus twice the worst-case
#: f32 summation error n * 2**-23 * sum|terms| (2**-23: the tensor
#: cores' accumulation may truncate), and 99 % within one ulp.
K2_F32_RTOL = 1e-5
K2_BF16_ULP = 2.0 ** -7
K2_BF16_OUTSIDE = 1e-3
K2_SUM_OUTSIDE = 1e-2
#: train phase: timed steps after the warmup steps, per CE variant
TRAIN_WARMUP, TRAIN_ITERS = 2, 8

#: K1's shapes: (B, T, h, d, causal, window); (a) is the training shape
K1_SHAPES = {"a": (8, 1024, 12, 64, True, None),
             "b": (2, 4096, 12, 64, True, 512),
             "c": (2, 1024, 8, 128, False, None)}
#: (d) the ring hop: (B, Ts, h, d), keys split in two halves of Ts
K1_HOP = (4, 1024, 12, 64)
K1_REPLACES = {
    "fwd": "kungfu_tpu/ops/flash.py:437 (_fwd_res_kernel, resident), "
           ":375 (_kernel, stream)",
    "dq": "kungfu_tpu/ops/flash.py:477 (_dq_res_kernel, resident), "
          ":801 (_bwd_dq_kernel, stream)",
    "dkv": "kungfu_tpu/ops/flash.py:510 (_dkv_res_kernel, resident), "
           ":845 (_bwd_dkv_kernel, stream)"}

#: the seq phase: long-context training on SEQ_RANKS rank processes that
#: share the card (one gloo group, `parallel.long_context`): GPT-2-small
#: with the ring and the Ulysses mixer through K1 (use_flash) at T = 4096
#: over a (data 1, seq 4) mesh, and BERT-base with the ring mixer at
#: T = 512 over (data 2, seq 2) — its non-causal hops
SEQ_RANKS = 4
SEQ_SPECS = [
    {"name": "gpt-ring", "model": "gpt", "size": "small",
     "attention": "ring", "use_flash": True, "mesh": [1, 4], "batch": 2,
     "seq_len": 4096, "steps": 3},
    {"name": "gpt-ulysses", "model": "gpt", "size": "small",
     "attention": "ulysses", "use_flash": True, "mesh": [1, 4], "batch": 2,
     "seq_len": 4096, "steps": 3},
    {"name": "bert-ring", "model": "bert", "attention": "ring",
     "use_flash": True, "mesh": [2, 2], "batch": 4, "seq_len": 512,
     "steps": 2},
]
#: how far the ring may sit from one process: the larger of twice the gap
#: between two correct one-process runs of the same model (GPT: flash
#: against the plain mixer, what bf16 rounding in another order moves;
#: BERT: its local mixer in bf16 against f32) and a floor. The step-1
#: loss floors are relative, set from the gaps the ring showed on the
#: H100 (GPT 3.5e-6, BERT 2.9e-5) with room; the gradient floor is on
#: the relative L2 error of each sampled gradient (each ring hop rounds
#: its output to bf16 before the merge: half an ulp, 2**-9, a hop)
SEQ_LOSS_FLOOR = {"gpt": 2e-5, "bert": 1e-4}
SEQ_GRAD_FLOOR = 2e-2
#: (d) K1's new cases: f32 at head dims 8..128 (fwd, dq and dkv up to 64
#: on the tf32 family, d 60 among them, at 128 on SIMT), bf16 off 64/128 (the
#: padded wgmma kernels: fwd, dq and dkv of D 64 and 128 up to d 128, of
#: D 256 at 136, 184, 200 and 256; at d 1, 4 and 20 on a zero-padded
#: copy of 8, 8 and 24 columns), at B 2, T 256, H 4 in each mode; the
#: fold launch: B 1100 x H 60 = 66000 > 65535
K1_NEW = ([("float32", d) for d in (8, 16, 32, 60, 64, 128)]
          + [("bfloat16", d) for d in (1, 4, 8, 16, 20, 24, 32, 40, 72, 96,
                                        120, 136, 184, 200, 256)])
K1_NEW_SHAPE = (2, 256, 4)
K1_NEW_MODES = {"causal": (True, None), "full": (False, None),
                "window": (True, 48)}
K1_FOLD = (1100, 64, 60, 16)
#: K1 off bf16 d 64/128 at its shapes on the main path, where each kernel
#: is timed and held to its plain version, all causal: f32 at the flash
#: benchmark's (e') (B 8, T 1024, H 12, d 64: the tf32 fwd, dq and dkv);
#: bf16 at the `tiny` GPT's training shape (e) (B 8, T 1024, H 8, d 16:
#: the wgmma fwd, dq and dkv padded to 64); bf16 at (e'')'s head dim 256
#: (B 4, T 1024, H 8: the D-256 wgmma fwd, dq and dkv); bf16 at (e''')'s
#: head dim 252 (the same B, T, H: the same kernels on a zero-padded
#: copy, timed with the copy); f32 at (e'''')'s head dim 128 (the same B,
#: T, H: the SIMT fwd, dq and dkv)
K1_SIMT_TIMING = {"float32": (8, 1024, 12, 64), "bfloat16": (8, 1024, 8, 16),
                  "bfloat16.d256": (4, 1024, 8, 256),
                  "bfloat16.d252": (4, 1024, 8, 252),
                  "float32.d128": (4, 1024, 8, 128)}
#: (e'') and (e''') the bf16 flash benchmark at head dim 256 (Gemma's)
#: and 252, (e'''') the f32 one at head dim 128: the shapes of
#: K1_SIMT_TIMING["bfloat16.d256"], ["bfloat16.d252"] and
#: ["float32.d128"], a few timed calls
K1_D256_BENCH = dict(batch=4, seq=1024, heads=8, head_dim=256, iters=4,
                     warmup=1)
K1_D252_BENCH = dict(K1_D256_BENCH, head_dim=252)
K1_F32_D128_BENCH = dict(K1_D256_BENCH, head_dim=128, dtype="float32")

#: R1: the bandwidth suite's stream shape (0.5 GiB of bf16)
R1_SHAPE = (262144, 1024)
R1_REPLACES = "kungfu_tpu/benchmarks/roofline.py:237"
#: bf16 bit patterns R1 must negate as torch.neg does: +-0, +-inf, quiet
#: and signalling NaNs of both signs, +-smallest denormal, +-max, 1
R1_SPECIALS = (0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC0, 0xFFC0, 0x7F81,
               0xFF81, 0x7FFF, 0x0001, 0x8001, 0x7F7F, 0xFF7F, 0x3F80)
#: the ResNet-50 S-SGD run: sync_sgd's gradient all-reduces a step (one
#: per parameter leaf)
RESNET_LEAVES = 161
#: the zoo phase: warmup and timed steps of VGG16 and InceptionV3, BERT's
#: timed steps a variant (interleaved blocks of 3), the CIFAR run's steps
ZOO_WARMUP, ZOO_ITERS, ZOO_BERT_ITERS, ZOO_CIFAR_STEPS = 2, 8, 12, 30
T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def pools(torch, dtype, seed=0):
    """A serving-shaped pool: 12 layers x (512 blocks + scratch), as
    `DecodeEngine(max_batch=8, block_tokens=16, max_len=1024)` holds."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    nbp1 = BATCH * MAX_BLOCKS + 1
    shape = (LAYERS * nbp1, BT, HEADS, HEAD_DIM)
    kp = torch.randn(shape, generator=g, device=DEVICE).to(dtype)
    vp = torch.randn(shape, generator=g, device=DEVICE).to(dtype)
    return kp, vp, nbp1


def tables_for(torch, lengths, seed=1):
    g = torch.Generator().manual_seed(seed)
    tbl = (torch.randperm(BATCH * MAX_BLOCKS, generator=g) + 1).reshape(
        BATCH, MAX_BLOCKS).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32)
    tbl[lens == 0] = 0
    return tbl.to(DEVICE), lens.to(DEVICE)


def phase_kernel(torch, pa):
    """Both schemes against the plain version; returns max errors."""
    errs = {}
    lengths = [0, 15, 16, 17, 511, 1023, 255, 700]
    tables, lens = tables_for(torch, lengths)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        kp, vp, nbp1 = pools(torch, dtype)
        g = torch.Generator(device=DEVICE).manual_seed(2)
        q = torch.randn(BATCH, HEADS, HEAD_DIM, generator=g,
                        device=DEVICE).to(dtype)
        base = (LAYERS // 2) * nbp1         # a middle layer of the pool
        ref = pa.paged_attention_reference(q, kp, vp, tables, lens,
                                           block_base=base)
        plan = pa.paged_plan(MAX_BLOCKS, BT, HEADS, HEAD_DIM, dtype=dtype)
        for scheme in ("resident", "stream"):
            got = pa.paged_attention(q, kp, vp, tables, lens,
                                     block_base=base, scheme=scheme)
            again = pa.paged_attention(q, kp, vp, tables, lens,
                                       block_base=base, scheme=scheme)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()),
                  f"{scheme} {name}: non-finite output")
            check(torch.equal(got, again),
                  f"{scheme} {name}: a second launch gave other bits")
            err = (got.float() - ref.float()).abs()
            atol, rtol = TOL[name]
            bad = err > atol + rtol * ref.float().abs()
            errs[(scheme, name)] = float(err.max())
            log(f"kernel {scheme:8s} {name:8s} max_abs_err "
                f"{errs[(scheme, name)]:.3e} (tolerance {atol:g} + "
                f"{rtol:g}*|ref|), second launch bitwise equal; "
                f"{plan['splits']} splits of {plan['split_blocks']} blocks "
                f"(grid {plan['splits']} x {HEADS} x {BATCH}), tiles of "
                f"{plan['tile_blocks']} blocks, smem {plan[scheme + '_bytes']}"
                f" B")
            check(not bool(bad.any()), f"{scheme} {name}: "
                  f"{int(bad.sum())} elements outside tolerance")
        del kp, vp
    return errs


def k2_inputs(torch, fc, seed=0):
    """Padded fused-head operands at the training shape: x [8192, 768]
    bf16 (rows past N zero), W [768, 50304] bf16 ~ N(0, 1/H), b f32
    (padded columns _PAD_BIAS), t int32 with -1 on the pad rows and on
    every 97th row, and a target >= v_pad on every 101st row (a valid
    row whose target lies in another vocab shard); scale = 1/N_valid."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    n_pad = -(-K2_N // fc.ROW_MULTIPLE) * fc.ROW_MULTIPLE
    v_pad = -(-K2_V // fc.COL_MULTIPLE) * fc.COL_MULTIPLE
    x = torch.zeros(n_pad, K2_H, device=DEVICE, dtype=torch.bfloat16)
    x[:K2_N] = torch.randn(K2_N, K2_H, generator=g, device=DEVICE)
    w = torch.zeros(K2_H, v_pad, device=DEVICE, dtype=torch.bfloat16)
    w[:, :K2_V] = torch.randn(K2_H, K2_V, generator=g, device=DEVICE) \
        * K2_H ** -0.5
    b = torch.full((1, v_pad), fc._PAD_BIAS, device=DEVICE)
    b[0, :K2_V] = torch.randn(K2_V, generator=g, device=DEVICE) * 0.02
    t = torch.full((n_pad, 1), -1, dtype=torch.int32, device=DEVICE)
    t[:K2_N, 0] = torch.randint(0, K2_V, (K2_N,), generator=g,
                                device=DEVICE, dtype=torch.int32)
    t[0:K2_N:97, 0] = -1
    t[5:K2_N:101, 0] = v_pad + 3
    scale = (1.0 / (t >= 0).sum().float()).reshape(1, 1)
    return x, w, b, t, scale


def k2_check(torch, name, got, ref, n_sum=0, absum=None):
    """Hold a K2 output against its plain version (tolerances above);
    `absum` is sum|terms| of each element of a long sum of `n_sum`
    products. Returns the max |got - ref|."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    top = float(ref.abs().max())
    if absum is not None:
        bound = K2_BF16_ULP * ref.abs() + 2 * n_sum * 2.0 ** -23 * absum
        outside = float((err > K2_BF16_ULP * ref.abs()).float().mean())
        log(f"kernel-K2 {name:6s} max_abs_err {float(err.max()):.3e} "
            f"(max |ref| {top:.3e}); beyond one bf16 ulp: {outside:.2e} "
            f"of elements (tolerance {K2_SUM_OUTSIDE:g}); max err / bound "
            f"{float(torch.where(bound > 0, err / bound, err).max()):.3f}")
        check(outside <= K2_SUM_OUTSIDE and not bool((err > bound).any()),
              f"K2 {name} outside tolerance")
    elif name in ("logits", "d"):
        outside = float((err > K2_BF16_ULP * ref.abs()).float().mean())
        log(f"kernel-K2 {name:6s} max_abs_err {float(err.max()):.3e} "
            f"(max |ref| {top:.3e}); beyond one bf16 ulp: {outside:.2e} "
            f"of elements (tolerance {K2_BF16_OUTSIDE:g}, and "
            f"{K2_BF16_ULP:g}*max|ref|)")
        check(outside <= K2_BF16_OUTSIDE
              and float(err.max()) <= K2_BF16_ULP * top,
              f"K2 {name} outside tolerance")
    else:
        bad = err > K2_F32_RTOL * (ref.abs() + top)
        log(f"kernel-K2 {name:6s} max_abs_err {float(err.max()):.3e} "
            f"(max |ref| {top:.3e}; tolerance {K2_F32_RTOL:g}*(|ref| + "
            f"max|ref|))")
        check(not bool(bad.any()), f"K2 {name}: {int(bad.sum())} elements "
              f"outside tolerance")
    check(bool(torch.isfinite(got).all()), f"K2 {name}: non-finite")
    return float(err.max())


def phase_kernel_k2(torch, fc):
    """The four K2 kernels against their plain versions at the training
    shape; returns {kernel: max_abs_err} (fwd: over lse, tl and the
    logits residual)."""
    x, w, b, t, scale = k2_inputs(torch, fc)
    plan = fc.fused_ce_plan(x.shape[0], K2_H, w.shape[1])
    log(f"kernel-K2 shape x {tuple(x.shape)} W {tuple(w.shape)}; plan "
        f"{json.dumps(plan)}")
    errs = {}
    rl, rlse, rtl = fc.plain_fwd(x, w, b, t, True)
    logits, lse, tl = fc.fused_ce_fwd(x, w, b, t, True)
    _, lse2, tl2 = fc.fused_ce_fwd(x, w, b, t, False)
    torch.cuda.synchronize()
    errs["fwd"] = max(k2_check(torch, "lse", lse, rlse),
                      k2_check(torch, "tl", tl, rtl),
                      k2_check(torch, "lse-nr", lse2, rlse),
                      k2_check(torch, "tl-nr", tl2, rtl),
                      k2_check(torch, "logits", logits, rl))
    check(float(tl[0]) == 0.0 and float(tl[5]) == 0.0,
          "K2 fwd: a sentinel target hit a column")
    loss, _ = fc._loss_from(lse, tl, t)
    ref_loss, _ = fc._loss_from(rlse, rtl, t)
    k2_check(torch, "loss", loss.reshape(1), ref_loss.reshape(1))
    del logits
    d, db = fc.fused_ce_residual_d(scale, rl.clone(), rlse, t)
    rd, rdb = fc.plain_residual_d(scale, rl, rlse, t)
    torch.cuda.synchronize()
    errs["residual_d"] = k2_check(torch, "d", d, rd)
    k2_check(torch, "db", db, rdb)
    check(not bool(d[0].float().any()) and not bool(d[:, K2_V:].float()
                                                     .any()),
          "K2 residual_d: gradient on a dropped row or a padded column")
    del d, rd, rl
    torch.cuda.empty_cache()
    dw, db = fc.fused_ce_dw(scale, x, w, b, t, rlse)
    rdw, rdb = fc.plain_dw(scale, x, w, b, t, rlse)
    # sum|terms| of each product element: |x|^T |bf16(d)| and |bf16(d)| |W|^T
    ad = fc._d_f32(fc._logits_f32(x, w, b), rlse, t, scale).to(
        torch.bfloat16).float().abs()
    torch.cuda.synchronize()
    errs["dw"] = k2_check(torch, "dW", dw, rdw, x.shape[0],
                          x.float().abs().t() @ ad)
    k2_check(torch, "db-dw", db, rdb)
    del dw, rdw
    torch.cuda.empty_cache()
    dx = fc.fused_ce_dx(scale, x, w, b, t, rlse)
    rdx = fc.plain_dx(scale, x, w, b, t, rlse)
    torch.cuda.synchronize()
    errs["dx"] = k2_check(torch, "dx", dx, rdx, w.shape[1],
                          ad @ w.float().abs().t())
    del ad
    check(not bool(dx[0].float().any()), "K2 dx: gradient on a dropped row")
    torch.cuda.empty_cache()
    return errs


def k1_inputs(torch, b, t, h, d, seed):
    """q, k, v, dO [B, T, h, d] bf16 ~ N(0, 1) from a seed."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn(b, t, h, d, generator=g, device=DEVICE).to(
        torch.bfloat16) for _ in range(4)]


def k1_check(torch, tag, name, got, ref, bound):
    """Hold a K1 output against its plain version with the element-wise
    tolerance of `ops.flash.kernel_error_bounds` (its docstring gives
    the reasons): |got - ref| <= 2**-8 |ref| + bound for the bf16 o, dq,
    dk and dv, <= bound for the f32 lse and delta. Returns max |err|."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if name in ("o", "dq", "dk", "dv"):
        bound = bound + 2.0 ** -8 * ref.abs()
    ratio = float((err / bound).max())
    log(f"kernel-K1 {tag} {name:5s} max_abs_err {float(err.max()):.3e} (max "
        f"|ref| {float(ref.abs().max()):.3e}); max err / tolerance "
        f"{ratio:.3f}")
    check(bool(torch.isfinite(got).all()), f"K1 {tag} {name}: non-finite")
    check(ratio <= 1.0, f"K1 {tag} {name}: outside tolerance")
    return float(err.max())


def k1_case(torch, fl, tag, b, t, h, d, causal, window, seed=0):
    """The three kernels on one shape against their plain versions on
    the same inputs: dq and the plain dq get the forward kernel's (o,
    lse), dkv and the plain dkv also the dq kernel's delta. Returns
    {kernel: max_abs_err}."""
    q, k, v, do = k1_inputs(torch, b, t, h, d, seed)
    plan = fl.flash_plan(t, d, causal, window)
    log(f"kernel-K1 ({tag}) B={b} T={t} h={h} d={d} causal={causal} "
        f"window={window}; plan {json.dumps(plan)}")
    o, lse = fl.flash_fwd(q, k, v, causal, None, window)
    dq, delta = fl.flash_dq(q, k, v, o, lse, do, causal, None, window)
    dk, dv = fl.flash_dkv(q, k, v, do, lse, delta, causal, None, window)
    torch.cuda.synchronize()
    f = [x.float() for x in (q, k, v, do)]
    ro, rlse = fl.plain_fwd(*f[:3], causal, None, window)
    bound = fl.kernel_error_bounds(*f[:3], ro, rlse, f[3], causal, None,
                                   window)
    errs = {"fwd": max(k1_check(torch, tag, "o", o, ro, bound["o"]),
                       k1_check(torch, tag, "lse", lse, rlse, bound["lse"]))}
    del ro, rlse, bound
    bound = fl.kernel_error_bounds(*f[:3], o, lse, f[3], causal, None,
                                   window)
    rdq, rdelta = fl.plain_dq(*f[:3], o.float(), lse, f[3], causal, None,
                              window)
    errs["dq"] = max(k1_check(torch, tag, "dq", dq, rdq, bound["dq"]),
                     k1_check(torch, tag, "delta", delta, rdelta,
                              bound["delta"]))
    del rdq, rdelta
    rdk, rdv = fl.plain_dkv(*f[:3], f[3], lse, delta, causal, None, window)
    errs["dkv"] = max(k1_check(torch, tag, "dk", dk, rdk, bound["dk"]),
                      k1_check(torch, tag, "dv", dv, rdv, bound["dv"]))
    return errs


def k1_hop(torch, fl, seed=5):
    """(d) the ring hop: a causal sequence of 2 x 1024 tokens, B=4,
    h=12, d=64; the global (o, lse) of its second half from the plain
    forward over the whole sequence; `flash_bwd` of the second-half
    queries against each half of the keys (off-diagonal non-causal,
    diagonal causal) with that external (o, lse), against the plain hop
    formula (plain_dq / plain_dkv, as sequence.py:213-226 computes it).
    The two hops' dq must also sum to the whole sequence's dq rows."""
    b, ts, h, d = K1_HOP
    q, k, v, do = k1_inputs(torch, b, 2 * ts, h, d, seed)
    f = [x.float() for x in (q, k, v, do)]
    ro, rlse = fl.plain_fwd(*f[:3], True)
    o_g = ro[:, ts:].to(torch.bfloat16).contiguous()
    lse_g = rlse.reshape(b, h, 2 * ts)[..., ts:].reshape(b * h, ts) \
        .contiguous()
    q2, do2 = q[:, ts:].contiguous(), do[:, ts:].contiguous()
    errs, dq_sum, dq_bound = {}, 0.0, 0.0
    for half, causal in ((0, False), (1, True)):
        kh = k[:, half * ts:(half + 1) * ts].contiguous()
        vh = v[:, half * ts:(half + 1) * ts].contiguous()
        dq, dk, dv = fl.flash_bwd(q2, kh, vh, o_g, lse_g, do2, causal)
        torch.cuda.synchronize()
        g = [x.float() for x in (q2, kh, vh, do2)]
        rdq, rdelta = fl.plain_dq(*g[:3], o_g.float(), lse_g, g[3], causal)
        rdk, rdv = fl.plain_dkv(*g[:3], g[3], lse_g, rdelta, causal)
        bound = fl.kernel_error_bounds(*g[:3], o_g, lse_g, g[3], causal)
        tag = f"(d) hop {half}"
        errs[half] = max(k1_check(torch, tag, "dq", dq, rdq, bound["dq"]),
                         k1_check(torch, tag, "dk", dk, rdk, bound["dk"]),
                         k1_check(torch, tag, "dv", dv, rdv, bound["dv"]))
        dq_sum = dq_sum + dq.float()
        dq_bound = dq_bound + bound["dq"] + 2.0 ** -8 * rdq.abs()
    # the hops' shares add up to the whole sequence's gradient (the
    # plain backward over all 2048 tokens, second-half rows)
    full_dq, _ = fl.plain_dq(*f[:3], ro.to(torch.bfloat16).float(), rlse,
                             f[3], True)
    err = (dq_sum - full_dq[:, ts:]).abs()
    log(f"kernel-K1 (d) hop0 + hop1 dq vs the whole sequence's dq: "
        f"max_abs_err {float(err.max()):.3e}; max err / tolerance "
        f"{float((err / dq_bound).max()):.3f}")
    check(bool((err <= dq_bound).all()), "K1 hop: dq shares do not add up")
    return max(errs.values())


def phase_kernel_k1(torch, fl):
    """K1 against its plain versions at shapes (a)-(d); returns case
    (a)'s {kernel: max_abs_err} (the training shape)."""
    errs = {tag: k1_case(torch, fl, tag, *shape)
            for tag, shape in K1_SHAPES.items()}
    torch.cuda.empty_cache()
    k1_hop(torch, fl)
    torch.cuda.empty_cache()
    return errs["a"]


def phase_kernel_r1(torch, st):
    """R1 bitwise against its plain version (torch.neg) on the same
    inputs — the suite's shape, ragged rows, the plan's edge lengths,
    every bf16 bit pattern and the specials — and a second launch
    bitwise equal to the first; returns the max |kernel - plain| over the
    finite values (0 when the bits agree)."""
    g = torch.Generator(device=DEVICE).manual_seed(9)
    specials = torch.tensor(R1_SPECIALS, dtype=torch.int32).to(torch.int16)
    cases = {
        f"suite {list(R1_SHAPE)}": torch.randn(R1_SHAPE, generator=g,
                                               device=DEVICE),
        "ragged rows [1000, 1024]": torch.randn(1000, 1024, generator=g,
                                                device=DEVICE),
    }
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, n in st.r1_edge_lengths(sms).items():
        cases[f"{name} ({n})"] = torch.randn(n, generator=g, device=DEVICE)
    cases = {k: v.to(torch.bfloat16) for k, v in cases.items()}
    # the specials repeated to 8 * 37 + 5 elements: vectors and the tail
    cases["specials x301"] = specials.repeat(22)[:301].view(
        torch.bfloat16).to(DEVICE)
    cases["every bf16 bit pattern (65536)"] = torch.arange(
        65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).to(
            DEVICE)
    err = 0.0
    for name, x in cases.items():
        got = st.stream_neg(x)
        ref = st.plain_neg(x)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int16), ref.view(torch.int16))
        finite = torch.isfinite(ref)
        e = float((got.float() - ref.float())[finite].abs().max())
        err = max(err, e)
        log(f"kernel-R1 {name}: bitwise equal to torch.neg: {same}; "
            f"max_abs_err {e:.3e}")
        check(same, f"R1 {name}: bits differ from torch.neg")
    x = cases[f"suite {list(R1_SHAPE)}"]
    first, second = st.stream_neg(x), st.stream_neg(x)
    torch.cuda.synchronize()
    check(torch.equal(first.view(torch.int16), second.view(torch.int16)),
          "R1: a second launch differs from the first")
    log(f"kernel-R1 second launch bitwise equal to the first; plan "
        f"{st.r1_plan(x.numel(), sms)}")

    def bits(t):
        return [hex(v & 0xFFFF) for v in t.view(torch.int16).tolist()]

    nan = cases["specials x301"][4:9].clone()    # 16-byte aligned
    log(f"kernel-R1 NaNs {bits(nan)}: kernel {bits(st.stream_neg(nan))}, "
        f"torch.neg {bits(torch.neg(nan))}")
    return err


def phase_resnet(torch):
    """bench.py's ResNet-50 S-SGD run through `measure_rate` under a
    one-rank NCCL group; returns its meta with images/s."""
    import torch.distributed as dist

    from kungfu_tpu_torch.benchmarks.throughput import measure_rate

    rate, meta = measure_rate("resnet50", 1)
    losses = meta["losses"]
    check(meta["backend"] == "nccl" and meta["chips"] == 1
          and meta["per_chip_batch"] == 128 and meta["image_size"] == 224,
          f"resnet: not bench.py's configuration: {meta}")
    check(all(x == x and abs(x) < 1e9 for x in losses),
          f"resnet: non-finite losses {losses}")
    check(losses[-1] < losses[0], f"resnet: the loss did not fall "
          f"({losses[0]} -> {losses[-1]})")
    check(meta["bn_stats_finite"] and meta["bn_stats_max_change"] > 0,
          "resnet: BatchNorm running statistics non-finite or unmoved")
    check(meta["grad_all_reduces_per_step"] == RESNET_LEAVES,
          f"resnet: sync_sgd issued {meta['grad_all_reduces_per_step']} "
          f"all-reduces a step, expected {RESNET_LEAVES}")
    check(not dist.is_initialized(), "resnet: the process group outlived "
          "the run")
    meta["images_per_sec"] = rate
    log(f"resnet ResNet-50 S-SGD (NCCL, one rank): {rate:.1f} images/s, "
        f"{meta['step_time_ms']:.2f} ms/step, peak memory "
        f"{meta['peak_mem_gb']:.2f} GB, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {len(losses)} steps, BN stats moved "
        f"{meta['bn_stats_max_change']:.3e}")
    log("resnet " + json.dumps(meta))
    return meta


def phase_roofline(torch, st):
    """The port's roofline main path: R1's launches zeroed just before,
    read just after."""
    from kungfu_tpu_torch.benchmarks.roofline import roofline_report

    torch.cuda.synchronize()
    st.reset_launches()
    rep = roofline_report()
    torch.cuda.synchronize()
    launches = dict(st.LAUNCHES)
    check(launches["neg"] > 0 and launches["neg"] ==
          rep["stream_kernel_launches"] and launches["plain"] == 0,
          f"roofline: R1 launches {launches}")
    for name, gbs in rep["achieved_by_pattern_gb_per_s"].items():
        log(f"roofline {name:13s} {gbs:9.1f} GB/s = "
            f"{gbs / (PEAK_BYTES_S / 1e9):.3f} of {PEAK_BYTES_S / 1e12:.2f} "
            f"TB/s")
    log(f"roofline ResNet-50 step {rep['resnet50_step_ms']:.2f} ms; R1 "
        f"launches {launches['neg']}")
    log("roofline " + json.dumps(rep))
    return launches["neg"]


def phase_timing_r1(torch, st):
    """R1 per launch at the suite's shape (0.5 GiB in, 0.5 GiB out: far
    beyond L2), beside its byte bound and torch.neg — the plain version
    and the library call are the same call here — each over 50 launches
    by device time (`time_device`: ``ms``, ``plain_ms``) and by events
    (`time_cuda`: ``event_ms``, ``plain_event_ms``); ``ratio`` is R1 over
    torch.neg by device time."""
    x = torch.randn(R1_SHAPE, device=DEVICE).to(torch.bfloat16)
    nbytes = 2 * x.numel() * x.element_size()
    r = {"bound_ms": 1e3 * nbytes / PEAK_BYTES_S}
    r["event_ms"] = time_cuda(torch, lambda i: st.stream_neg(x), 50)
    r["plain_event_ms"] = time_cuda(torch, lambda i: st.plain_neg(x), 50)
    r["ms"] = time_device(torch, lambda i: st.stream_neg(x), 50)
    r["plain_ms"] = time_device(torch, lambda i: st.plain_neg(x), 50)
    r["ratio"] = r["ms"] / r["plain_ms"]
    log(f"timing R1 neg {r['ms']:.4f} ms/launch by device time "
        f"({r['event_ms']:.4f} by events); bound {r['bound_ms']:.4f} ms "
        f"(bytes: {nbytes} B); plain = library = torch.neg "
        f"{r['plain_ms']:.4f} ms ({r['plain_event_ms']:.4f}); R1 / "
        f"torch.neg {r['ratio']:.4f}; {1e-6 * nbytes / r['ms']:.1f} GB/s "
        f"achieved, torch.neg {1e-6 * nbytes / r['plain_ms']:.1f} GB/s")
    return r


def phase_train(torch, fc, fl, variant, attention="local"):
    """GPT-2-small training through the normal entry point; returns the
    benchmark's meta with the K2 and K1 launch counts of this run (K1's
    without the launches of the flash efficiency probe that
    `measure_lm_rate` runs after the training loop)."""
    from kungfu_tpu_torch.benchmarks.lm import measure_lm_rate

    tag = f"{variant}/{attention}"
    torch.cuda.synchronize()
    fc.reset_launches()                     # counts of THIS run only
    fl.reset_launches()
    rate, meta = measure_lm_rate("small", 8, 1024, attention=attention,
                                 ce_variant=variant, iters=TRAIN_ITERS,
                                 warmup=TRAIN_WARMUP)
    torch.cuda.synchronize()
    launches = dict(fc.LAUNCHES)
    probe = meta.get("flash_kernel", {}).get("launches", {})
    k1 = {n: c - probe.get(n, 0) for n, c in fl.LAUNCHES.items()}
    steps = TRAIN_WARMUP + TRAIN_ITERS
    losses = meta["losses"]
    check(len(losses) == steps and all(x == x and abs(x) < 1e9
                                       for x in losses),
          f"train {tag}: non-finite losses {losses}")
    check(losses[-1] < losses[0], f"train {tag}: the loss did not "
          f"fall ({losses[0]} -> {losses[-1]})")
    want = ({"fwd": steps, "residual_d": steps, "dw": 0, "dx": 0}
            if variant == "residual" else
            {"fwd": steps, "residual_d": 0, "dw": steps, "dx": steps})
    got = {k: launches[k] for k in want}
    check(got == want and launches["plain"] == 0,
          f"train {tag}: K2 launches {launches}, expected {want} and "
          f"no plain call")
    n = LAYERS * steps if attention == "flash" else 0
    want1 = {"fwd": n, "dq": n, "dkv": n, "plain": 0}
    check(k1 == want1 and fl.LAUNCHES["plain"] == 0,
          f"train {tag}: K1 launches {k1} (probe {probe}), expected {want1}")
    meta.update(tokens_per_sec=rate, launches=launches, k1_launches=k1)
    log(f"train {tag}: {meta['step_time_ms']:.2f} ms/step, "
        f"{rate:.1f} tok/s, MFU {meta['mfu']} (against 989e12 bf16), "
        f"peak memory {meta['peak_mem_gb']:.2f} GB, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; K2 launches {launches}; "
        f"K1 launches {k1}")
    log("train " + json.dumps(meta))
    return meta


#: the elastic phase: (a) grow 1 -> 2, shrink to 1 with an eviction (and
#: (c) the same schedule on the bucketed wire); (b) two workers, rank 1
#: killed after step 3, the survivor recovers; (d) saved at np 2 every 2
#: steps, the whole cluster killed at step 5, restored at np 1; (e) the
#: GNS loop, 2 -> 4
ELASTIC_GROW = ("3:1,6:2,1:1", 10)
#: (c)'s bf16 run: (a)'s schedule cut by three steps (one at size 1, two
#: at size 2) to keep the whole smoke near its time budget beside the
#: adaptive phase; `none` keeps (a)'s, whose digests it must equal
ELASTIC_GROW_BF16 = ("2:1,4:2,1:1", 7)
ELASTIC_RECOVERY = (1, 3, 8, 2)     # crash rank, crash step, steps, np
ELASTIC_RESTORE = (2, 1, 5, 2)      # save np, restore np, kill step, every
#: the whole-cluster kills ((d) and scenario (a)) run with one generation
#: in flight: a save waits for the previous write, so the generation
#: before the kill's last save is complete however slow the disk. With
#: the double buffer, (d)'s restore needed step 2's 1.6 GB a rank
#: written within the three steps before the kill, and a slower disk
#: left no complete generation at all
CKPT_DURABLE_ENV = {"KF_CKPT_MAX_PENDING": "1"}
#: steps the restored cluster trains past the kill step
ELASTIC_RESTORE_STEPS = 2
ELASTIC_KERNELS = {"flash": ("fwd", "dq", "dkv"),
                   "fused_ce": ("fwd", "residual_d")}
#: rank 0 profiles three steps at this size (`KF_PROFILE_SIZE`)
ELASTIC_PROFILE_SIZE = 2
#: the bucketed wire: the reference's default bucket, both compressions
#: the run compares
ELASTIC_BUCKET_MB = "1"
#: KF_STEP fields a report takes medians of
STEP_FIELDS = ("wall_ms", "compute_ms", "wire_ms", "stage_ms", "exposed_ms",
               "pack_ms", "host_ms", "land_ms", "lag_ms", "payload",
               "buckets")


def _kv(line: str) -> dict:
    """The ``key=value`` fields of a worker's marker line."""
    out = {}
    for tok in line.split():
        k, sep, v = tok.partition("=")
        if sep:
            out[k] = v
    return out


def _marker_lines(logs: str, marker: str):
    return [_kv(l) for l in logs.splitlines() if l.startswith(marker + " ")]


def _med(rows, key):
    vals = sorted(float(r[key]) for r in rows)
    return vals[len(vals) // 2]


def check_launches(tag: str, logs: str, device: str) -> dict:
    """Each worker's K1/K2 launches: every kernel of the path positive and
    the plain versions never on the card (plain only on the CPU); returns
    the sums."""
    launches = [l for l in logs.splitlines() if l.startswith("KF_LAUNCHES")]
    check(launches, f"elastic {tag}: no worker printed its launches")
    totals = {f"{m}.{k}": 0 for m, ks in ELASTIC_KERNELS.items()
              for k in ks}
    for line in launches:
        kv = {}
        for tok in line.split()[3:]:
            name, _, js = tok.partition("=")
            kv[name] = json.loads(js)
        for mod, names in ELASTIC_KERNELS.items():
            counts = kv[mod]
            if device == "cuda":
                check(all(counts[n] > 0 for n in names)
                      and counts["plain"] == 0,
                      f"elastic {tag}: {mod} launches {counts} in {line}")
            else:
                check(counts["plain"] > 0, f"elastic {tag}: {line}")
            for n in names:
                totals[f"{mod}.{n}"] += counts[n]
    return totals


def elastic_report(tag: str, logs: str, card: str, device: str,
                   resyncs: bool = True):
    """Check one elastic run's worker logs and print its numbers: each
    worker's K1/K2 launches (`check_launches`), every digest agreed, and
    per cluster size rank 0's median step fields (wall, compute, wire —
    the libkf all-reduce, or the pipeline's summed wire ops — and
    staging; on the bucketed wire also the exposed wire, the packers',
    host and landing ms, the payload, the bucket count and the arrival
    lag) over the steps rank 0 did not profile, its device idle share
    (KF_IDLE), the resyncs' ms and bytes, the KF_MTTR phases and each
    worker's peak memory. A run with `resyncs` must show digests.
    Returns (launch sums, {size: medians}, the KF_IDLE fields or
    None)."""
    totals = check_launches(tag, logs, device)
    digests = _marker_lines(logs, "KF_DIGEST")
    check((digests or not resyncs)
          and all(d["agreed"] == "True" for d in digests),
          f"elastic {tag}: digests {digests}")
    idle = next((d for d in _marker_lines(logs, "KF_IDLE")
                 if d["rank"] == "0"), None)
    profiled = set()
    if idle is not None:
        lo, hi = (int(x) for x in idle["steps"].split("-"))
        profiled = set(range(lo, hi + 1))
        log(f"elastic {tag} device idle share, rank 0 at size "
            f"{idle['size']} over steps {idle['steps']} (torch.profiler, "
            f"this process's kernels and copies; the other worker shares "
            f"the card): wall {idle['wall_ms']} ms, busy {idle['busy_ms']} "
            f"ms, idle {idle['idle']} ({idle['wire']} wire; {card})")
    steps = [d for d in _marker_lines(logs, "KF_STEP") if d["rank"] == "0"]
    by_size, meds = {}, {}
    for d in steps:
        by_size.setdefault(int(d["size"]), []).append(d)
    for size, rows in sorted(by_size.items()):
        plain = [r for r in rows if int(r["step"]) not in profiled] or rows
        med = {k: _med(plain, k) for k in STEP_FIELDS if k in plain[0]}
        meds[size] = med
        extra = ""
        if "exposed_ms" in med:
            extra = (f", exposed wire {med['exposed_ms']:.2f}, pack "
                     f"{med['pack_ms']:.2f}, host {med['host_ms']:.2f}, "
                     f"land {med['land_ms']:.2f}, arrival lag "
                     f"{med['lag_ms']:.2f}, payload {int(med['payload'])} B "
                     f"in {int(med['buckets'])} buckets "
                     f"({plain[0]['compression']})")
        log(f"elastic {tag} size {size}: rank-0 step median wall "
            f"{med['wall_ms']:.2f} ms, compute {med['compute_ms']:.2f}, "
            f"wire {med['wire_ms']:.2f}, staging {med['stage_ms']:.2f}"
            f"{extra} over steps {[int(r['step']) for r in plain]} "
            f"(profiled {sorted(profiled & {int(r['step']) for r in rows})}"
            f"); walls {[float(r['wall_ms']) for r in rows]} ({card})")
    for d in _marker_lines(logs, "KF_RESYNC"):
        log(f"elastic {tag} resync: rank {d['rank']} size {d['size']} step "
            f"{d['step']} {float(d['ms']):.1f} ms, {int(d['bytes'])} bytes "
            f"({card})")
    for line in logs.splitlines():
        if line.startswith("KF_MTTR"):
            log(f"elastic {tag} {line} ({card})")
        elif line.startswith(("KF_JOINER_CONTINUITY", "KF_JOINER_BOOT",
                              "KF_SURVIVOR_CONTI",
                              "KF_DIGEST", "evicted at step", "resized:",
                              "KF_RECOVERY_", "KF_RESTORE_CONTINUITY",
                              "KF_CKPT_")):
            log(f"elastic {tag} {line}")
    for d in _marker_lines(logs, "KF_PEAK_MEM"):
        log(f"elastic {tag} peak memory of worker {d['peer']} (rank "
            f"{d['rank']} at exit): {d['gb']} GB ({card})")
    log(f"elastic {tag}: {len(digests)} digests agreed; launches "
        f"{json.dumps(totals)}")
    return totals, meds, idle


def _add(totals: dict, more: dict) -> None:
    for k, v in more.items():
        totals[k] += v


def phase_elastic_restore(card: str, flags, device: str) -> dict:
    """(d): `run_checkpoint_restore` with the bf16 bucketed wire (so the
    residual sidecars ride along): saved at np 2 every 2 steps with one
    generation in flight, the whole cluster SIGKILLed at step 5,
    restored at np 1. Prints each
    rank's generation bytes (the shard files on disk), the save's
    synchronous stall, the snapshot's memory, the writer's time, the
    restore time and fresh against restored loss."""
    import re
    import tempfile

    from kungfu_tpu_torch.elastic.harness import (claim_port_span,
                                                  run_checkpoint_restore)

    save_np, restore_np, kill, every = ELASTIC_RESTORE
    root = os.path.join(HERE, "build", "elastic-ckpt")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root) as tmp, \
            claim_port_span() as span:
        ckpt_dir = os.path.join(tmp, "ckpt")
        logs = run_checkpoint_restore(
            ckpt_dir, save_np=save_np, restore_np=restore_np,
            kill_step=kill, save_every=every, slots=save_np,
            port_range=span, timeout=420, logdir=os.path.join(tmp, "logs"),
            worker_flags=flags, restore_steps=ELASTIC_RESTORE_STEPS,
            extra_env={"KF_GRAD_BUCKET_MB": ELASTIC_BUCKET_MB,
                       "KF_GRAD_COMPRESS": "bf16", **CKPT_DURABLE_ENV})
        save_logs = ""
        save_dir = os.path.join(tmp, "logs", "save")
        for f in sorted(os.listdir(save_dir)):
            if f.endswith(".log"):
                with open(os.path.join(save_dir, f)) as fh:
                    save_logs += fh.read()
        gens = {}
        for g in sorted(os.listdir(ckpt_dir)):
            files = sorted(os.listdir(os.path.join(ckpt_dir, g)))
            gens[g] = {f: os.path.getsize(os.path.join(ckpt_dir, g, f))
                       for f in files}
    check("KF_CKPT_RESTORE_NONE" not in logs,
          "elastic restore: a rank found no generation")
    restored = _marker_lines(logs, "KF_RESTORE_CONTINUITY")
    check(len(restored) == restore_np and all(
        float(d["restored"]) < float(d["fresh"]) - 0.05 for d in restored),
        f"elastic restore: {restored}")
    check(f"KF_CONTINUITY_DONE rank=0 size={restore_np}" in logs,
          "elastic restore: the restored cluster did not finish")
    log(f"elastic restore (np {save_np} saving every {every} steps, killed "
        f"at step {kill}, restored at np {restore_np}; one generation in "
        f"flight): "
        f"{time.perf_counter() - t0:.1f} s")
    for g, files in gens.items():
        log(f"elastic restore generation {g} on disk: {json.dumps(files)}")
    saves = _marker_lines(save_logs, "KF_CKPT_SAVED")
    check(saves and all(d["max_pending"] == CKPT_DURABLE_ENV[
        "KF_CKPT_MAX_PENDING"] for d in saves),
          f"elastic restore: a save ran at another depth: {saves}")
    for d in saves:
        log(f"elastic restore save: rank {d['rank']} gen {d['gen']} "
            f"synchronous stall {d['stall_ms']} ms (residual copy "
            f"{d['residual_ms']}, save() {d['save_ms']}, the card's queue "
            f"{d['sync_ms']}), snapshot "
            f"{int(d['snapshot_device_bytes'])} B on the card + "
            f"{int(d['snapshot_host_bytes'])} B on the host ({card})")
    for d in _marker_lines(save_logs, "KF_CKPT_WRITTEN"):
        log(f"elastic restore writer: rank {d['rank']} gen {d['gen']} "
            f"{int(d['bytes'])} B, writer {d['writer_ms']} ms (hash "
            f"{d['hash_ms']}, write {d['write_ms']}) ({card})")
    for d in restored:
        log(f"elastic restore: rank {d['rank']} at size {d['size']} from "
            f"step {d['step']}: {d['restore_ms']} ms for {d['bytes']} B; "
            f"first-batch loss fresh {d['fresh']} vs restored "
            f"{d['restored']} ({card})")
    check(re.search(r"^KF_CKPT_RESIDUALS rank=0 adopted", logs, re.M),
          "elastic restore: rank 0 did not adopt its residuals")
    totals, _, _ = elastic_report("restore", logs, card, device,
                                  resyncs=False)
    return totals


def phase_elastic_gns(card: str, device: str) -> None:
    """(e): the GNS loop, `elastic.gns_worker`s on the card (sharing it),
    grown 2 -> 4 because the noise-scale monitor asked for it."""
    from kungfu_tpu_torch.elastic.harness import (claim_port_span,
                                                  run_gns_adaptation)

    t0 = time.perf_counter()
    with claim_port_span() as span:
        logs = run_gns_adaptation(total_steps=10, ramp_step=4, start_np=2,
                                  slots=4, port_range=span, timeout=300,
                                  worker_flags=["--device", device])
    readings = {}
    for line in logs.splitlines():
        if line.startswith("--- worker-"):
            who = line.split()[1]
        elif line.startswith("step "):
            readings.setdefault(who, []).append(line.split()[3])
        elif line.startswith(("monitor-resize", "joined at", "finished")):
            log(f"elastic gns {who}: {line}")
    for who, vals in readings.items():
        log(f"elastic gns {who} noise-scale readings {vals}")
    log(f"elastic gns 2 -> 4: {time.perf_counter() - t0:.1f} s ({card})")


def phase_elastic(torch, card: str, device: str = DEVICE) -> dict:
    """The elastic training worker path through the port's harness:
    config server, ``kfrun -w``, GPT-2-small continuity workers sharing
    the card. (a) grow 1 -> 2 and shrink to 1 with an eviction, on the
    lump; (b) two workers, one killed, the survivor recovers; (c) (a)'s
    schedule on the bucketed wire, ``none``, then ``bf16`` on a shorter
    one; (d) the
    durable rung; (e) the GNS loop. Rank 0 profiles three size-2 steps
    of (a) and (c) for the device's idle share. Returns the workers'
    K1/K2 launches summed over every run."""
    from kungfu_tpu_torch.elastic.harness import (claim_port_span,
                                                  run_loss_continuity,
                                                  run_survivor_recovery)

    flags = ["--model", "gpt", "--device", device]
    profile = {"KF_PROFILE_SIZE": str(ELASTIC_PROFILE_SIZE)}
    meds, digests = {}, {}
    totals = None
    for tag, env, (schedule, steps) in (
            ("grow", {}, ELASTIC_GROW),
            ("bucketed none", {"KF_GRAD_BUCKET_MB": ELASTIC_BUCKET_MB,
                               "KF_GRAD_COMPRESS": "none"}, ELASTIC_GROW),
            ("bucketed bf16", {"KF_GRAD_BUCKET_MB": ELASTIC_BUCKET_MB,
                               "KF_GRAD_COMPRESS": "bf16"},
             ELASTIC_GROW_BF16)):
        t0 = time.perf_counter()
        with claim_port_span() as span:
            logs = run_loss_continuity(schedule=schedule, total_steps=steps,
                                       start_np=1, slots=2, port_range=span,
                                       timeout=420, worker_flags=flags,
                                       extra_env={**profile, **env})
        check("evicted at step" in logs, f"elastic {tag}: no eviction")
        check(f"KF_CONTINUITY_DONE rank=0 size=1 step={steps}" in logs,
              f"elastic {tag}: the survivor did not finish at size 1")
        check(len(_marker_lines(logs, "KF_DIGEST")) >= 3,
              f"elastic {tag}: a resync without its digest check")
        # the runner's warm pool: the grow's joiner starts from a slot
        # whose interpreter and imports were paid before the resize
        boots = _marker_lines(logs, "KF_JOINER_BOOT")
        check(len(boots) == 1 and boots[0]["warm"] == "1",
              f"elastic {tag}: the joiner was not warm-activated: {boots}")
        check(int(boots[0]["nice"]) == os.getpriority(os.PRIO_PROCESS, 0),
              f"elastic {tag}: the joiner's threads run at nice "
              f"{boots[0]['nice']}, not the runner's")
        log(f"elastic {tag} 1 -> 2 -> 1 ({schedule}, {steps} steps): "
            f"{time.perf_counter() - t0:.1f} s")
        got, meds[tag], _ = elastic_report(tag, logs, card, device)
        digests[tag] = [d["digest"] for d in _marker_lines(logs, "KF_DIGEST")
                        if d["rank"] == "0"]
        if totals is None:
            totals = got
        else:
            _add(totals, got)
        if tag != "grow":
            lump, bucketed = meds["grow"].get(2), meds[tag].get(2)
            check(lump and bucketed, f"elastic {tag}: no size-2 steps")
            log(f"elastic size 2, rank-0 medians, lump vs {tag} (this "
                f"call): wall {lump['wall_ms']:.2f} vs "
                f"{bucketed['wall_ms']:.2f} ms, compute "
                f"{lump['compute_ms']:.2f} vs {bucketed['compute_ms']:.2f}, "
                f"exposed wire {lump['wire_ms'] + lump['stage_ms']:.2f} "
                f"(all-reduce + staging) vs {bucketed['exposed_ms']:.2f}, "
                f"wire ops {lump['wire_ms']:.2f} vs "
                f"{bucketed['wire_ms']:.2f}, pack + land "
                f"{lump['stage_ms']:.2f} (staging) vs "
                f"{bucketed['pack_ms'] + bucketed['land_ms']:.2f} ({card})")
    # the same seeded training: `none` sums the same f32 values as the
    # lump, so every resync's parameter digest is the lump run's
    check(digests["bucketed none"] == digests["grow"],
          f"elastic: the bucketed none wire's parameters differ from the "
          f"lump's: {digests}")
    log(f"elastic: bucketed none's parameter digests equal the lump's at "
        f"every resync {digests['grow']}; bf16's {digests['bucketed bf16']}")
    crash_rank, crash_step, steps, start_np = ELASTIC_RECOVERY
    t0 = time.perf_counter()
    with claim_port_span() as span:
        logs = run_survivor_recovery(crash_rank=crash_rank,
                                     crash_step=crash_step,
                                     total_steps=steps, start_np=start_np,
                                     slots=start_np, port_range=span,
                                     timeout=420, worker_flags=flags)
    check("KF_CONTINUITY_DONE rank=0" in logs,
          "elastic recovery: the survivor did not finish")
    log(f"elastic recovery (rank {crash_rank} killed after step "
        f"{crash_step}, {steps} steps, np {start_np}): "
        f"{time.perf_counter() - t0:.1f} s")
    _add(totals, elastic_report("recovery", logs, card, device)[0])
    _add(totals, phase_elastic_restore(card, flags, device))
    phase_elastic_gns(card, device)
    return totals


#: the adaptive phase. (a) steps each in-step wrapper (and AdaSGD's
#: switch) takes in process against its inner optimizer; (b) the libkf
#: GPT-2-small cells: workers and timed steps (after the benchmark's 2
#: warm-up steps), no straggler; (c) the reference test's straggler
#: contrast (tests/test_straggler.py:14-16): workers, straggler ms a
#: step (rank 0), timed steps, batch
ADAPTIVE_STEPS, ADAPTIVE_CHANGE_STEP = 3, 2
ADAPTIVE_GPT = (2, 6)
ADAPTIVE_STRAGGLER = (4, 120, 20, 64)
#: the reference test's ordering: pair's cluster rate under the
#: straggler above this multiple of sync's
ADAPTIVE_PAIR_OVER_SYNC = 1.5


def _launch_totals(launches: dict) -> dict:
    """``{"flash.fwd": n, ...}`` of a flash / fused-CE launch dict pair,
    the path's kernels (`ELASTIC_KERNELS`) only."""
    return {f"{m}.{k}": launches[m][k] for m, ks in ELASTIC_KERNELS.items()
            for k in ks}


def phase_adaptive_wrappers(torch, fc, fl, card: str) -> dict:
    """(a): GPT-2-small at full width (batch 8 x 1024, flash, residual
    CE, `lm_adamw`) under a one-rank NCCL group: `ADAPTIVE_STEPS` steps
    under the plain inner optimizer, then from the same seeded initial
    parameters under `sma`, `pair_averaging` and `ada_sgd` (switch at
    `ADAPTIVE_CHANGE_STEP`, `broadcast_params` there). At one rank the
    mean of a parameter is itself and each blend adds 0, so every
    wrapper's parameters must equal the inner's (`torch.equal`). Returns
    the K1/K2 launches of the four runs."""
    import torch.distributed as dist

    from kungfu_tpu_torch.benchmarks.lm import build_lm_model
    from kungfu_tpu_torch.elastic.continuity_worker import gpt_corpus
    from kungfu_tpu_torch.models.gpt import gpt_fused_loss
    from kungfu_tpu_torch.optimizers import (ada_sgd, lm_adamw,
                                             pair_averaging, sma)
    from kungfu_tpu_torch.parallel import (broadcast_params, data_mesh,
                                           init_distributed,
                                           shutdown_distributed)

    wrappers = {"inner": lambda o, m: o, "sma": sma,
                "pair_averaging": pair_averaging,
                "ada_sgd": lambda o, m: ada_sgd(
                    o, m, change_step=ADAPTIVE_CHANGE_STEP)}
    tokens = torch.from_numpy(gpt_corpus(1024)[:8]).to(DEVICE)
    torch.cuda.synchronize()
    fc.reset_launches()
    fl.reset_launches()
    init_distributed(device=DEVICE)
    try:
        mesh = data_mesh(1)
        check(dist.get_backend() == "nccl" and mesh.world == 1,
              f"adaptive (a): not a one-rank NCCL group: {mesh}")
        ref, runs = None, {}
        _, model = build_lm_model("small", 1024, DEVICE, attention="flash")
        params = list(model.parameters())
        init = [p.detach().clone() for p in params]
        for name, wrap in wrappers.items():
            with torch.no_grad():       # every run from the seeded init
                for p, p0 in zip(params, init):
                    p.copy_(p0)
            opt = wrap(lm_adamw(params), mesh)
            ms, losses = [], []
            for k in range(ADAPTIVE_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if name == "ada_sgd" and k == ADAPTIVE_CHANGE_STEP:
                    broadcast_params(model, mesh)
                opt.zero_grad(set_to_none=False)
                loss = gpt_fused_loss(model, tokens, residual=True)
                loss.backward()
                opt.step()
                losses.append(float(loss.detach()))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            final = [p.detach().clone() for p in params]
            if ref is None:
                ref = final
            else:
                same = sum(torch.equal(a, b) for a, b in zip(final, ref))
                check(same == len(ref), f"adaptive (a): {name}'s "
                      f"parameters differ from the inner optimizer's in "
                      f"{len(ref) - same} of {len(ref)} tensors")
            per_step = getattr(opt, "collectives", 0) / ADAPTIVE_STEPS
            if name in ("sma", "ada_sgd"):
                check(per_step == len(params), f"adaptive (a): {name} "
                      f"issued {per_step} collectives a step, expected "
                      f"{len(params)} (one a parameter)")
            runs[name] = ms
            equal = ("" if name == "inner" else
                     "; parameters torch.equal the inner optimizer's")
            log(f"adaptive (a) {name}: ms/step {[f'{t:.2f}' for t in ms]}"
                f" (inner: {[f'{t:.2f}' for t in runs['inner']]}), "
                f"{per_step:g} collectives a step over {len(params)} "
                f"parameters, loss {losses[0]:.4f} -> {losses[-1]:.4f}"
                f"{equal} ({card})")
            del opt, final
        del model, params, init, ref
        torch.cuda.empty_cache()
    finally:
        shutdown_distributed()
    torch.cuda.synchronize()
    launches = _launch_totals({"flash": fl.LAUNCHES,
                               "fused_ce": fc.LAUNCHES})
    n = len(wrappers) * ADAPTIVE_STEPS
    want = {"flash.fwd": LAYERS * n, "flash.dq": LAYERS * n,
            "flash.dkv": LAYERS * n, "fused_ce.fwd": n,
            "fused_ce.residual_d": n}
    check(launches == want and fl.LAUNCHES["plain"] == 0
          and fc.LAUNCHES["plain"] == 0,
          f"adaptive (a): launches {launches}, expected {want}, plain "
          f"{fl.LAUNCHES['plain']} / {fc.LAUNCHES['plain']}")
    check(not dist.is_initialized(), "adaptive (a): the process group "
          "outlived the run")
    return launches


def phase_adaptive_libkf(card: str) -> dict:
    """(b): `benchmarks.straggler --model gpt` at np 2 on the card, one
    clean cell each for ``sma`` and ``pair``. Each worker's K1/K2 must
    have launched and their plain versions never, its loss must fall,
    and the pair workers must have mixed in at least one round. Returns
    the workers' K1/K2 launches summed."""
    from kungfu_tpu_torch.benchmarks.straggler import WARMUP, measure

    workers, steps = ADAPTIVE_GPT
    t0 = time.perf_counter()
    res = measure(np_=workers, straggler_ms=0, steps=steps,
                  strategies=("sma", "pair"), model="gpt", device=DEVICE,
                  timeout=600)
    totals = {f"{m}.{k}": 0 for m, ks in ELASTIC_KERNELS.items()
              for k in ks}
    for strategy, entry in res.items():
        for rank, r in sorted(entry["cells"]["clean"].items()):
            tag = f"adaptive (b) {strategy} rank {rank}"
            fl_n, fc_n = r["launches"]["flash"], r["launches"]["fused_ce"]
            got = _launch_totals(r["launches"])
            check(all(v > 0 for v in got.values()) and fl_n["plain"] == 0
                  and fc_n["plain"] == 0, f"{tag}: launches {r['launches']}")
            _add(totals, got)
            check(r["last_loss"] < r["first_loss"], f"{tag}: the loss did "
                  f"not fall ({r['first_loss']} -> {r['last_loss']})")
            if strategy == "pair":
                check(r["skipped"] < steps, f"{tag}: skipped "
                      f"{r['skipped']} of {steps + WARMUP} rounds")
            split = ", ".join(f"{k} {v:.2f}" for k, v in
                              r["split_ms"].items())
            log(f"{tag}: {r['samples_per_sec']:.3f} samples/s, "
                f"{r['tokens_per_sec']:.1f} tokens/s over {steps} steps "
                f"of {r['batch']} x 1024 ({r['wall_s']:.3f} s); step "
                f"medians, ms: {split}; skipped {r['skipped']}; loss "
                f"{r['first_loss']:.4f} -> {r['last_loss']:.4f}; peak "
                f"memory {r['peak_mem_gb']} GB; parameter gap to the "
                f"ranks' mean {r['param_gap']:.6g}; launches {json.dumps(got)}"
                f" ({r['kind']}; {card})")
        log(f"adaptive (b) {strategy}: cluster {entry['clean_samples_per_sec']:.3f}"
            f" samples/s at np {workers} ({card})")
    log(f"adaptive (b): {time.perf_counter() - t0:.1f} s")
    return totals


def phase_adaptive_straggler(card: str) -> None:
    """(c): the reference test's straggler contrast at its own model
    (the SLP) on the card: np 4, rank 0 sleeping 120 ms a step, 20
    steps of 64, ``sync`` and ``pair``, clean and with the straggler.
    Pair's cluster rate under the straggler must beat sync's by the
    reference's 1.5x."""
    from kungfu_tpu_torch.benchmarks.straggler import measure

    workers, ms, steps, batch = ADAPTIVE_STRAGGLER
    t0 = time.perf_counter()
    res = measure(np_=workers, straggler_ms=ms, steps=steps, batch=batch,
                  strategies=("sync", "pair"), model="slp", device=DEVICE,
                  timeout=420)
    for strategy, r in res.items():
        rates = {cell: {k: round(w["samples_per_sec"], 1)
                        for k, w in sorted(ws.items())}
                 for cell, ws in r["cells"].items()}
        log(f"adaptive (c) {strategy}: clean {r['clean_samples_per_sec']:.3f}"
            f" samples/s, straggler {r['straggler_samples_per_sec']:.3f},"
            f" retention {r['retention']:.4f}; by rank {json.dumps(rates)}"
            f" ({card})")
    sync, pair = res["sync"], res["pair"]
    ratio = (pair["straggler_samples_per_sec"]
             / sync["straggler_samples_per_sec"])
    log(f"adaptive (c): pair / sync under the straggler {ratio:.3f} "
        f"(reference test: > {ADAPTIVE_PAIR_OVER_SYNC}; its retentions: "
        f"sync < 0.6, pair > 0.55); {time.perf_counter() - t0:.1f} s")
    check(ratio > ADAPTIVE_PAIR_OVER_SYNC,
          f"adaptive (c): pair's straggler rate is {ratio:.3f}x sync's: "
          f"{json.dumps({k: {x: v for x, v in r.items() if x != 'cells'} for k, r in res.items()})}")


def phase_adaptive(torch, fc, fl, card: str) -> dict:
    """The adaptive optimizers: (a) the in-step wrappers, (b) the libkf
    GPT-2-small workers under SMA and pair averaging, (c) the straggler
    contrast. Returns the K1/K2 launches of (a) and (b)."""
    t0 = time.perf_counter()
    totals = phase_adaptive_wrappers(torch, fc, fl, card)
    torch.cuda.empty_cache()
    _add(totals, phase_adaptive_libkf(card))
    phase_adaptive_straggler(card)
    log(f"adaptive: {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(totals)}")
    return totals


#: the serve-tier phase: the decode workers' environment (GPT-2-small
#: at full width and depth in bf16, phase 3's engine settings), the new
#: tokens of `default_requests`' twelve, the warm-up requests before
#: the measured ones, (b)'s added requests (enough that the queue
#: outlasts the survivors' stall and the joiner's warm-up, so the joiner
#: decodes; (b) runs at the ledger's default lease), and (c)'s fault:
#: rank 1 killed at this decode iteration, under a short lease so the
#: dead worker's requests come back quickly
SERVE_TIER_ENV = {"KF_SERVE_MODEL": "small", "KF_SERVE_MAX_LEN": str(MAX_LEN),
                  "KF_SERVE_MAX_BATCH": str(BATCH),
                  "KF_SERVE_PREFILL_CHUNK": "256",
                  "KF_SERVE_SHARE_PREFIX": "1"}
SERVE_TIER_GEN = 64
SERVE_TIER_WARMUP = 2
SERVE_TIER_GROW_EXTRA = 60
SERVE_TIER_KILL_STEP = 20
SERVE_TIER_KILL_LEASE_MS = "3000"
SERVE_TIER_TIMEOUT = 300


def tier_requests(vocab: int):
    """Phase 3's 12 requests (`serve_requests`) and
    `default_requests(12, gen_len=64)`: [(prompt, max_new), ...]."""
    from kungfu_tpu_torch.serve.harness import default_requests

    return ([(p, m) for _, p, m in serve_requests(vocab)]
            + default_requests(12, gen_len=SERVE_TIER_GEN, vocab=vocab))


def tier_report(tag: str, cell: dict, out: dict, card: str,
                every_worker: bool = False) -> None:
    """Check one tier run's workers and print its numbers: each worker's
    K3 launches (plain never; with `every_worker`, each worker's scheme
    above 0 and the other scheme at 0; the run's sum above 0), and from
    `cell` (`benchmarks.serve.measure_cell`'s) p50/p99 latency and
    generated tokens/s over the measured requests and each worker's
    decode, prefill, control, resize and warm ms and peak memory."""
    logs = out["logs"]
    schemes = {l["rank"]: l["kernel"]
               for l in _marker_lines(logs, "KF_SERVE_READY")}
    rows = _marker_lines(logs, "KF_LAUNCHES")
    check(rows, f"serve-tier {tag}: no worker printed its launches")
    for row in rows:
        counts = json.loads(row["paged_attn"])
        check(counts["plain"] == 0, f"serve-tier {tag}: K3's plain "
              f"version ran on the card: {row}")
        if every_worker:
            scheme = schemes.get(row["rank"])
            other = "stream" if scheme == "resident" else "resident"
            check(scheme in counts and counts[scheme] > 0
                  and counts[other] == 0,
                  f"serve-tier {tag}: worker {row} ran {scheme!r}")
    k3 = cell["timing"]["paged_attn"]
    # a late joiner may find the queue empty: the run as a whole must
    # have launched
    check(k3["resident"] + k3["stream"] > 0,
          f"serve-tier {tag}: no decode step ran: {rows}")
    log(f"serve-tier {tag}: {cell['requests']} requests, p50 "
        f"{cell['p50_ms']} ms, p99 {cell['p99_ms']} ms, "
        f"{cell['tokens_per_sec']} generated tok/s over "
        f"{cell['measured_wall_s']} s; K3 launches {json.dumps(k3)}; "
        f"resumed {cell['resumed_requests']} ({card})")
    # the membership events, in log order: who joined, resized,
    # recovered, left, and (c)'s kill with its recovery phases
    for line in logs.splitlines():
        if line.startswith(("KF_SERVE_JOINER", "KF_SERVE_RESIZED",
                            "KF_SERVE_RECOVERED", "KF_SERVE_EVICTED",
                            "KF_SERVE_DRAINED", "KF_CHAOS_FIRE",
                            "KF_MTTR")):
            log(f"serve-tier {tag}: {line.strip()}")
    for t in cell["timing"]["by_worker"]:
        log(f"serve-tier {tag} worker rank {int(t['rank'])}: steps "
            f"{int(t['steps'])}, decode {t['decode_ms']} ms, prefill "
            f"{t['prefill_ms']} ms ({int(t['prefill_chunks'])} chunks), "
            f"control {t['control_ms']} ms, resize {t['resize_ms']} ms, "
            f"warm {t['warm_ms']} ms, peak blocks {int(t['peak_blocks'])}, "
            f"peak memory {t['peak_mem_gb']} GB")


def phase_serve_tier(card: str, engine_tokens: dict) -> dict:
    """The kfserve tier through `benchmarks.serve.measure_cell` (the
    serve benchmark's cell over `serve.harness.run_serve_cluster`): a
    config server (or the replicated tier), ``kfrun -w`` and
    `serve.worker` replicas sharing the card, serving `tier_requests`
    after `SERVE_TIER_WARMUP` warm-up requests. (a) np 1 with
    KF_SERVE_KERNEL=auto (the plan's resident scheme) and np 2 with
    ``stream``; the token agreement with `engine_tokens` (phase 3's
    in-process engine on its 12 requests) is printed; (b) np 2 grown to
    3 through /addworker once the first measured request is done, with
    `SERVE_TIER_GROW_EXTRA` more requests, at the default lease, with a
    warm joiner and again with a cold one: the joiner decodes, and more
    requests are re-leased than their workers released only if a
    worker's gap between lease renewals outlasted the lease; (c) (b)'s
    tier behind a `ReplicaTier(n=3,
    wal_dir)` with a `Router` in front, rank 1 SIGKILLed at decode
    iteration `SERVE_TIER_KILL_STEP` with KF_RECOVER=1: every request
    completes, some re-leased. The harness checks every request done
    and the ledger's invariants empty. Returns the K3 launches summed
    over every worker of every run."""
    import tempfile

    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.benchmarks.serve import measure_cell
    from kungfu_tpu_torch.elastic.replica import ReplicaTier
    from kungfu_tpu_torch.serve.harness import (RECOVERY_MARKERS,
                                                RESIZE_MARKERS,
                                                default_requests)
    from kungfu_tpu_torch.serve.ledger import RequestLedger
    from kungfu_tpu_torch.serve.router import Router

    t_phase = time.perf_counter()
    reqs = tier_requests(50257)
    totals = {"resident": 0, "stream": 0, "plain": 0}

    def run(tag, np_, requests, every_worker=False, **kw):
        t0 = time.perf_counter()
        cell, out = measure_cell(np_, requests, device=DEVICE,
                                 timeout=SERVE_TIER_TIMEOUT,
                                 warmup=SERVE_TIER_WARMUP, **kw)
        tier_report(tag, cell, out, card, every_worker)
        for k in totals:
            totals[k] += cell["timing"]["paged_attn"][k]
        log(f"serve-tier {tag}: {time.perf_counter() - t0:.1f} s")
        return cell, out

    for np_, kernel in ((1, "auto"), (2, "stream")):
        _, out = run(
            f"(a) np {np_} {kernel}", np_, reqs, every_worker=True,
            slots=np_, extra_env={**SERVE_TIER_ENV,
                                  "KF_SERVE_KERNEL": kernel})
        got = [r["tokens"] for r in out["results"][:len(engine_tokens)]]
        agree = sum(a == b for i, t in enumerate(got)
                    for a, b in zip(t, engine_tokens[i]))
        total = sum(len(t) for t in engine_tokens.values())
        log(f"serve-tier (a) np {np_} {kernel}: token agreement with "
            f"phase 3's in-process engine on its 12 requests "
            f"{agree}/{total} (bf16, other batch compositions: printed, "
            f"not checked)")
    grow_reqs = reqs + default_requests(SERVE_TIER_GROW_EXTRA,
                                        gen_len=SERVE_TIER_GEN, vocab=50257)
    lease_ms = RequestLedger().lease_ms

    def grow_cell(tag, prewarm):
        """(b)'s grow 2 -> 3 with the runner's warm pool on (`prewarm`
        "1", the default: the joiner must be activated from a warm
        slot) or off ("0": the joiner starts cold); returns the cell,
        the survivors' longest stall, the joiner's boot fields and the
        longest gap between a worker's lease renewals across the
        switch."""
        grow, out = run(tag, 2, grow_reqs, slots=3,
                        grow_when_done=SERVE_TIER_WARMUP + 1,
                        markers=RESIZE_MARKERS,
                        extra_env={**SERVE_TIER_ENV, "KF_PREWARM": prewarm})
        logs = out["logs"]
        check("KF_SERVE_RESIZED rank=0 size=3" in logs,
              f"serve-tier {tag}: rank 0 never reached size 3")
        boot = _marker_lines(logs, "KF_SERVE_JOINER")[0]
        check(boot.get("warm") == prewarm,
              f"serve-tier {tag}: the joiner's boot {boot} (KF_PREWARM="
              f"{prewarm}: warm={prewarm} expected)")
        joiner = int(boot["rank"])
        steps = {int(t["rank"]): int(t["steps"])
                 for t in grow["timing"]["by_worker"]}
        check(steps.get(joiner, 0) > 0,
              f"serve-tier {tag}: the joiner (rank {joiner}) decoded "
              f"nothing: steps by rank {steps}")
        stall_ms = max(float(l["stall_ms"])
                       for l in _marker_lines(logs, "KF_SERVE_RESIZED"))
        check(int(boot["nice"]) == os.getpriority(os.PRIO_PROCESS, 0),
              f"serve-tier {tag}: the joiner's threads run at nice "
              f"{boot['nice']}, not the runner's")
        # a request is re-leased only when its holder released it
        # (`released`) or its lease expired, which takes a gap between
        # the holder's renewals longer than the lease (`renew_gap_ms`,
        # the start of one renewal to the end of the next)
        rows = grow["timing"]["by_worker"]
        gap = max(t["renew_gap_ms"] for t in rows)
        switch_gap = max(t["switch_gap_ms"] for t in rows)
        released = int(sum(t["released"] for t in rows))
        stale = int(sum(t["stale"] for t in rows))
        resumed = grow["resumed_requests"]
        check(resumed <= released or gap > lease_ms,
              f"serve-tier {tag}: {resumed} requests re-leased, "
              f"{released} released by their workers, with the longest "
              f"gap between a worker's lease renewals {gap} ms under the "
              f"{lease_ms} ms lease")
        log(f"serve-tier {tag}: {resumed} of {grow['requests']} requests "
            f"re-leased at the default {lease_ms:.0f} ms lease ({released} "
            f"released by their workers, {stale} appends refused as "
            f"stale); the survivors' longest stall in the epoch switch "
            f"{stall_ms} ms, the longest gap between a worker's lease "
            f"renewals {gap} ms ({switch_gap} ms across the switch); "
            f"joiner rank {joiner} (warm={boot['warm']}, nice "
            f"{boot['nice']}) decoded {steps[joiner]} steps; p99 through "
            f"the resize {grow['p99_ms']} ms, the stall included ({card})")
        return grow, stall_ms, boot, switch_gap

    warm = grow_cell("(b) grow 2 -> 3", "1")
    cold = grow_cell("(b) cold contrast, KF_PREWARM=0", "0")
    phases = ("main_ms", "import_ms", "init_ms", "build_ms", "resync_ms")
    log(f"serve-tier (b) warm vs cold joiner (this call): survivors' stall "
        f"{warm[1]} vs {cold[1]} ms; the gap between lease renewals across "
        f"the switch {warm[3]} vs {cold[3]} ms; p99 through the grow "
        f"{warm[0]['p99_ms']} vs {cold[0]['p99_ms']} ms; the joiner's boot "
        + ", ".join(f"{p[:-3]} {warm[2][p]} vs {cold[2][p]}" for p in phases)
        + f" ms ({card})")
    fault = json.dumps({"faults": [{"type": "crash_worker", "rank": 1,
                                    "step": SERVE_TIER_KILL_STEP,
                                    "signal": "KILL"}]})
    with tempfile.TemporaryDirectory() as wal_dir:
        tier = ReplicaTier(n=3, lease_ms=500.0, wal_dir=wal_dir)
        router = Router(tier.bases, flush_ms=2.0).start()
        try:
            tier.wait_leader(10)
            kill, out = run(
                "(c) kill behind the replicated tier", 2, reqs, slots=3,
                schedule="999:2", recover=True, server=tier,
                submit_url=router.base,
                markers=RECOVERY_MARKERS[:3],
                extra_env={**SERVE_TIER_ENV, **tier.env(),
                           "KF_CHAOS": fault,
                           "KF_SERVE_LEASE_MS": SERVE_TIER_KILL_LEASE_MS,
                           "KF_RETRY_ATTEMPTS": "10",
                           "KF_RETRY_DEADLINE_MS": "30000"})
            logs = out["logs"]
            check("KF_SERVE_RECOVERED" in logs
                  or "KF_SERVE_RESIZED rank=0 size=1" in logs,
                  "serve-tier (c): the survivor neither recovered nor "
                  "shrank")
            resumed = kill["resumed_requests"]
            check(resumed > 0, "serve-tier (c): no request was re-leased "
                  "after the kill")
            check(router.healthz()["submitted"]
                  == SERVE_TIER_WARMUP + len(reqs),
                  f"serve-tier (c): the router admitted "
                  f"{router.healthz()['submitted']} requests")
            check(all(r.status()["wal"] for r in tier.replicas),
                  "serve-tier (c): a replica kept no WAL")
            log(f"serve-tier (c): {resumed} requests re-leased after the "
                f"kill; replicas' seq "
                f"{[r.status()['seq'] for r in tier.replicas]}, leader "
                f"{tier.leader().index}")
        finally:
            router.stop()
            tier.stop()
            chaos.load(None)
            chaos._reset()
    log(f"serve-tier: {time.perf_counter() - t_phase:.1f} s; K3 launches "
        f"{json.dumps(totals)}")
    return totals


#: the scenario phase: (a) the training replay — the canned scenario,
#: its start size and the batch a GPT-2-small worker trains at; (b) the
#: serving replay — the canned scenario and its start size, the decode
#: workers under serve-tier's settings but the scenario's own batch and
#: lease; the reference test's checks on (a): the kill step and the
#: step-ranks of the whole run (12 steps x 2 ranks)
SCENARIO_TRAIN = ("spot_preempt", 2, 8)
SCENARIO_SERVE = ("spot_serve_kill", 2)
SCENARIO_SERVE_ENV = {k: v for k, v in SERVE_TIER_ENV.items()
                      if k != "KF_SERVE_MAX_BATCH"}
SCENARIO_KILL_STEP, SCENARIO_USEFUL = 8, 24
SCENARIO_TIMEOUT = 420


def phase_scenario(card: str) -> dict:
    """The scenario engine on the card (`scenario.run_scenario`). (a)
    `spot_preempt` at np0 2 with GPT-2-small continuity workers (batch
    8 x 1024, flash attention, residual fused CE, AdamW, f32 master
    weights, bf16 compute) sharing the card: the whole allocation is
    SIGKILLed at step 8 and a second launch restores from the sharded
    checkpoints (one generation in flight, `CKPT_DURABLE_ENV`); ``python -m kungfu_tpu_torch.trace --goodput`` must
    hold the reference test's checks, and every worker that ran to its
    end must have launched K1 and K2, their plain versions never (the
    killed ones print no counts). (b) `spot_serve_kill` at np0 2 through
    the decode tier (GPT-2-small bf16, phase 3's seeded weights): rank 1
    is SIGKILLed at its 8th iteration, its requests are re-leased, the
    schedule re-grows the tier; every request done, the ledger's
    invariants empty (the harness's gate), the fault fired, K3 launched
    in the workers and its plain version never. Returns the workers'
    launches, K1/K2 from (a) and K3 from (b)."""
    import dataclasses
    import tempfile

    from kungfu_tpu_torch.benchmarks.goodput import _row
    from kungfu_tpu_torch.elastic.harness import claim_port_span
    from kungfu_tpu_torch.scenario import canned, run_scenario
    from kungfu_tpu_torch.serve.ledger import percentile

    root = os.path.join(HERE, "build", "scenario")
    os.makedirs(root, exist_ok=True)
    name, np0, batch = SCENARIO_TRAIN
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        trace_dir = os.path.join(tmp, "trace")
        with claim_port_span() as span:
            run = run_scenario(
                dataclasses.replace(canned(name, np0=np0),
                                    device_batch=batch),
                trace_dir=trace_dir, logdir=os.path.join(tmp, "logs"),
                port_range=span, timeout=SCENARIO_TIMEOUT,
                extra_env=CKPT_DURABLE_ENV,
                worker_flags=["--model", "gpt", "--device", DEVICE])
        out = subprocess.run(
            [sys.executable, "-m", "kungfu_tpu_torch.trace", "--dir",
             trace_dir, "--goodput", "--device-batch", str(batch)],
            cwd=HERE, capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"scenario (a): the goodput CLI failed: "
          f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
    decomp = json.loads(out.stdout[out.stdout.index("{"):])
    restored = decomp["restored_step"]
    lost = decomp["lost_steps_by_rank"]
    check(decomp["invariant"]["ok"]
          and decomp["invariant"]["error_pct"] <= 5.0,
          f"scenario (a): invariant {decomp['invariant']}")
    check(len(run.phase_logs) == 2 and restored is not None
          and restored < SCENARIO_KILL_STEP,
          f"scenario (a): restored step {restored}")
    check(all(lost.get(str(r), 0) >= SCENARIO_KILL_STEP - restored
              for r in range(np0)),
          f"scenario (a): lost steps {lost} after restoring {restored}")
    check(decomp["useful_step_ranks"] >= SCENARIO_USEFUL,
          f"scenario (a): {decomp['useful_step_ranks']} useful step-ranks")
    totals = check_launches("scenario (a)", run.phase_logs[-1], DEVICE)
    row = _row(run, decomp)
    log(f"scenario (a) {name} np0 {np0}, GPT-2-small batch {batch} x "
        f"{MAX_LEN}: {time.perf_counter() - t0:.1f} s (phases "
        f"{list(run.phase_wall_s)} s, relaunch gap {run.relaunch_gap_s} "
        f"s); goodput ratio {row['goodput_ratio']}, phases % of the "
        f"ranks' active wall {json.dumps(row['phases_pct'])}, other "
        f"{row['other_pct']} %, wall {row['wall_ms']} ms, invariant "
        f"error {row['invariant_error_pct']} %; useful step-ranks "
        f"{row['useful_step_ranks']}, lost {row['lost_step_ranks']} "
        f"({json.dumps(lost)}), restored step {restored}, useful "
        f"samples/s {row['useful_samples_per_sec']} ({card})")
    for line in run.logs.splitlines():
        if line.startswith(("KF_CHAOS_FIRE", "KF_CKPT_SAVED",
                            "KF_CKPT_WRITTEN", "KF_RESTORE_CONTINUITY",
                            "KF_CONTINUITY_DONE")):
            log(f"scenario (a) {line}")
    log(f"scenario (a): launches of the relaunch's workers "
        f"{json.dumps(totals)}")

    name, np0 = SCENARIO_SERVE
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root) as tmp, \
            claim_port_span() as span:
        run = run_scenario(canned(name, np0=np0),
                           trace_dir=os.path.join(tmp, "trace"),
                           logdir=os.path.join(tmp, "logs"),
                           port_range=span, timeout=SCENARIO_TIMEOUT,
                           worker_flags=["--device", DEVICE],
                           extra_env=SCENARIO_SERVE_ENV)
    logs = run.logs
    check("type=crash_worker" in logs, "scenario (b): the kill never fired")
    check(run.results and all(r["state"] == "done" for r in run.results),
          "scenario (b): a request was not done")
    rows = _marker_lines(logs, "KF_LAUNCHES")
    check(rows, "scenario (b): no worker printed its launches")
    k3 = {"resident": 0, "stream": 0, "plain": 0}
    for r in rows:
        counts = json.loads(r["paged_attn"])
        check(counts["plain"] == 0, f"scenario (b): K3's plain version "
              f"ran on the card: {r}")
        for k in k3:
            k3[k] += counts[k]
    check(k3["resident"] > 0 and k3["stream"] == 0,
          f"scenario (b): the plan's resident scheme did not run: {rows}")
    lat = sorted(r["latency_ms"] for r in run.results)
    leased = sum(1 for r in run.results if r["leases"] > 1)
    log(f"scenario (b) {name} np0 {np0}: {time.perf_counter() - t0:.1f} s; "
        f"{len(run.results)} requests done, p50 "
        f"{percentile(lat, 50):.1f} ms, p99 {percentile(lat, 99):.1f} ms "
        f"(of {len(lat)} requests: the slowest, {lat[-1]:.1f} ms; a "
        f"liveness replay, not a latency cell), {leased} re-leased; K3 "
        f"launches {json.dumps(k3)} ({card})")
    for line in logs.splitlines():
        if line.startswith(("KF_CHAOS_FIRE", "KF_SERVE_RECOVERED",
                            "KF_SERVE_JOINER", "KF_SERVE_RESIZED",
                            "KF_MTTR")):
            log(f"scenario (b) {line.strip()}")
    totals.update({f"paged_attn.{k}": v for k, v in k3.items()})
    return totals


#: the benchmarks phase's shapes: the decode rate's (size, batch,
#: prompt, generated tokens, timed calls) and the AdamW variants
BENCH_DECODE = ("small", 8, 128, 128, 3)
ADAMW_VARIANTS = ("per-leaf", "grouped", "flat")


def phase_benchmarks(torch, pa, card: str) -> dict:
    """The port's benchmark entry points on the card. (a)
    `benchmarks.lm.measure_decode_rate` at `BENCH_DECODE` (GPT-2-small
    bf16 through `gpt_generate`'s dense cache): the warm-up call's tokens
    must equal the last timed call's. (b)
    `benchmarks.flash_eff.measure_paged_bandwidth` at its defaults (B=8,
    max_len 2048, bt 16, h 12, d 64, bf16): K3's counts zeroed just
    before and read just after — the plan's scheme launched once a call
    the measurement made, the other scheme and the plain version never;
    then one launch on the same inputs (`paged_inputs`) against
    `paged_attention_reference` at ``TOL["bfloat16"]``. (c)
    `benchmarks.throughput.measure_adamw_update("small", v)` for each
    of `ADAMW_VARIANTS`: after the same steps from the same state the
    three variants' parameters must be bitwise equal. Prints each
    number beside the card. Returns K3's launches by scheme."""
    from kungfu_tpu_torch.benchmarks import flash_eff, lm, throughput

    t0 = time.perf_counter()
    size, batch, prompt, gen, iters = BENCH_DECODE
    toks = []
    rate, meta = lm.measure_decode_rate(size, batch, prompt, gen,
                                        iters=iters, outputs=toks)
    check(tuple(toks[0].shape) == (batch, prompt + gen),
          f"decode tokens of shape {tuple(toks[0].shape)}")
    check(torch.equal(toks[0], toks[1]),
          "decode: the last timed call's tokens differ from the warm-up's")
    log(f"benchmarks (a) decode {size} batch {batch}, {prompt} + {gen}: "
        f"{rate:.1f} tok/s, {meta['ms_per_token']:.4f} ms/token "
        f"({iters} timed calls, tokens equal across calls) on {card}")
    torch.cuda.empty_cache()

    pa.reset_launches()
    meta = flash_eff.measure_paged_bandwidth()
    launches = dict(pa.LAUNCHES)
    plan = meta["plan"]
    scheme = plan["scheme"]
    other = "stream" if scheme == "resident" else "resident"
    check(launches[scheme] == meta["calls"] and launches[other] == 0
          and launches["plain"] == 0,
          f"paged: launches {launches} for {meta['calls']} calls of "
          f"{scheme}")
    inputs = flash_eff.paged_inputs(
        meta["batch"], meta["max_len"], meta["block_tokens"],
        meta["heads"], meta["head_dim"], torch.bfloat16, DEVICE)
    got = pa.paged_attention(*inputs, scheme=scheme).float()
    ref = pa.paged_attention_reference(*inputs).float()
    atol, rtol = TOL["bfloat16"]
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    check(bool(torch.isfinite(got).all()) and not bool(bad.any()),
          f"paged: {int(bad.sum())} elements outside tolerance "
          f"(max_abs_err {float(err.max()):.3e})")
    share = meta["achieved_gbps"] * 1e9 / PEAK_BYTES_S
    log(f"benchmarks (b) paged K3 {scheme} ({plan['splits']} splits of "
        f"{plan['split_blocks']} blocks, tiles of {plan['tile_blocks']}): "
        f"decode_ms {meta['decode_ms']:.5f}, bound_ms "
        f"{meta.get('bound_ms')}, {meta['achieved_gbps']:.1f} GB/s "
        f"({share:.3f} of 3.35 TB/s), visited {meta['visited_bytes']} B "
        f"= {meta['visited_fraction_of_pool']:.4f} of the pool; "
        f"{meta['calls']} launches, plain 0; one launch max_abs_err "
        f"{float(err.max()):.3e} (tolerance {atol:g} + {rtol:g}*|ref|) "
        f"on {card}")
    del inputs, got, ref
    torch.cuda.empty_cache()

    finals = {}
    for variant in ADAMW_VARIANTS:
        outs = []
        ms, m = throughput.measure_adamw_update("small", variant,
                                                outputs=outs)
        finals[variant] = outs[0]
        log(f"benchmarks (c) AdamW {variant:8s} {ms:.4f} ms/step, floor "
            f"{m.get('hbm_floor_ms_at_3350GBps')} ms "
            f"({m['hbm_floor_bytes']} B), floor_ratio "
            f"{m.get('floor_ratio')}; {m['n_leaves']} leaves, "
            f"{m['tail_leaves']} under 64k elements "
            f"({m['tail_frac_of_bytes']:.5f} of the bytes), "
            f"{m['iters']} timed steps on {card}")
        torch.cuda.empty_cache()
    base = finals[ADAMW_VARIANTS[0]]
    for variant in ADAMW_VARIANTS[1:]:
        check(all(torch.equal(a, b) for a, b in zip(base, finals[variant])),
              f"AdamW {variant}: parameters differ from per-leaf's")
    log(f"benchmarks (c) the three AdamW variants' parameters bitwise "
        f"equal after the same steps; phase {time.perf_counter() - t0:.1f} s")
    del finals, base
    torch.cuda.empty_cache()
    return {s: launches[s] for s in ("resident", "stream")}


def zoo_image(torch, model: str, catalog: str, card: str) -> dict:
    """(a)/(b): one zoo model through `measure_rate` at full size."""
    import torch.distributed as dist

    from kungfu_tpu_torch.benchmarks.throughput import measure_rate
    from kungfu_tpu_torch.models import fake_model_catalog

    rate, meta = measure_rate(model, 1, warmup=ZOO_WARMUP, iters=ZOO_ITERS)
    losses = meta["losses"]
    check(all(x == x and abs(x) < 1e9 for x in losses),
          f"zoo {model}: non-finite losses {losses}")
    check(losses[-1] < losses[0], f"zoo {model}: the loss did not fall "
          f"({losses[0]} -> {losses[-1]})")
    leaves = len(fake_model_catalog(catalog))
    check(meta["grad_all_reduces_per_step"] == leaves,
          f"zoo {model}: sync_sgd issued "
          f"{meta['grad_all_reduces_per_step']} all-reduces a step, the "
          f"{catalog} catalog has {leaves}")
    if model == "inception3":
        check(meta["bn_stats_finite"] and meta["bn_stats_max_change"] > 0,
              "zoo inception3: BatchNorm running statistics non-finite "
              "or unmoved")
    check(not dist.is_initialized(), f"zoo {model}: the process group "
          "outlived the run")
    log(f"zoo ({model}) {rate:.1f} images/s, {meta['step_time_ms']:.2f} "
        f"ms/step (batch {meta['per_chip_batch']} at "
        f"{meta['image_size']}, NCCL one rank), peak memory "
        f"{meta['peak_mem_gb']:.2f} GB, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {len(losses)} steps, "
        f"{leaves} all-reduces a step = the catalog's, BN stats moved "
        f"{meta['bn_stats_max_change']:.3e} on {card}")
    return {"images_per_sec": rate, **meta}


def zoo_helpers(torch, bert_state, card: str) -> None:
    """(e): prefetch into VGG16's step, the DCP manager on BERT's state,
    the dry-run entry."""
    import tempfile

    import numpy as np

    from kungfu_tpu_torch.benchmarks.throughput import build_image_train
    from kungfu_tpu_torch.checkpoint import DCPCheckpointManager
    from kungfu_tpu_torch.data import prefetch_to_device
    from kungfu_tpu_torch.datasets import synthetic_batches
    from kungfu_tpu_torch.dryrun import dryrun
    from kungfu_tpu_torch.parallel import (init_distributed,
                                           shutdown_distributed)

    n_batches, batch, image = 3, 64, 224
    src = synthetic_batches(batch, image, seed=3)
    host = [next(src) for _ in range(n_batches)]
    init_distributed(device="cuda")
    try:
        _, _, step, _ = build_image_train("vgg16", batch, image)
        pf = prefetch_to_device(
            ({"x": x, "y": y.astype(np.int64)} for x, y in host), 2,
            DEVICE)
        check(pf.stream is not None and pf.stream.cuda_stream
              != torch.cuda.default_stream().cuda_stream,
              "prefetch: the copies are not on a side stream")
        losses = []
        for (x, y), b in zip(host, pf):
            check(torch.equal(b["x"].cpu(), torch.from_numpy(x))
                  and torch.equal(b["y"].cpu(),
                                  torch.from_numpy(y.astype(np.int64))),
                  "prefetch: a batch differs from its host copy")
            losses.append(float(step(b)))
        check(pf.copies == 2 * n_batches and len(losses) == n_batches
              and all(np.isfinite(losses)),
              f"prefetch: {pf.copies} copies, losses {losses}")
    finally:
        shutdown_distributed()
    log(f"zoo (e) prefetch_to_device fed {n_batches} seeded ImageNet "
        f"batches of {batch} at {image} to VGG16's step on a side stream "
        f"({pf.copies} copies, values equal), losses {losses} on {card}")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="kf-zoo-ckpt-") as td:
        t0 = time.perf_counter()
        with DCPCheckpointManager(td, max_to_keep=1) as mgr:
            mgr.save(1, bert_state)
            queued_ms = 1e3 * (time.perf_counter() - t0)
            mgr.wait()
            saved_ms = 1e3 * (time.perf_counter() - t0)
            like = {k: torch.empty_like(v) for k, v in bert_state.items()}
            back, step_no = mgr.restore(like=like)
        check(step_no == 1 and all(
            back[k].device == v.device and torch.equal(back[k], v)
            for k, v in bert_state.items()),
            "checkpoint: the restored BERT state differs")
    nbytes = sum(v.numel() * v.element_size() for v in bert_state.values())
    log(f"zoo (e) DCPCheckpointManager: BERT-base state ({nbytes} B, "
        f"{len(bert_state)} tensors) save returned in {queued_ms:.1f} ms, "
        f"on disk after {saved_ms:.1f} ms, restored to the card bitwise "
        f"equal on {card}")
    out = dryrun(1, DEVICE)
    check(out["params_equal"] and np.isfinite(out["loss"]),
          f"dryrun: {out}")
    log(f"zoo (e) dryrun n=1 on the card: loss {out['loss']:.6f}, "
        f"parameters equal across ranks, on {card}")


def phase_zoo(torch, card: str) -> dict:
    """The rest of the training surface on the card (docstring phase
    12). Returns the figures the log line at the end repeats."""
    import argparse
    import tempfile

    from kungfu_tpu_torch.benchmarks import convergence_cv, publish

    t0 = time.perf_counter()
    out = {"vgg16": zoo_image(torch, "vgg16", "vgg16-imagenet", card)}
    torch.cuda.empty_cache()
    out["inception3"] = zoo_image(torch, "inception3",
                                  "inception3-imagenet", card)
    torch.cuda.empty_cache()
    args = argparse.Namespace(device=DEVICE, batch=16,
                              iters=ZOO_BERT_ITERS, lr=0.1)
    models = {}
    row = publish.run_bert_sma_gns(args, outputs=models)
    check(all(math.isfinite(v) for v in row["losses"].values()),
          f"zoo bert: non-finite losses {row['losses']}")
    with tempfile.TemporaryDirectory(prefix="kf-zoo-publish-") as td:
        with open(os.path.join(td, "BASELINE.json"), "w") as f:
            f.write("{}")
        publish.publish_result(
            "bert_sma_gns_monitor", dict(row),
            parsed={"metric": "bert_gns_overhead_pct",
                    "value": row["gns_overhead_pct"]},
            cmd="chip_smoke.py zoo (c)", directory=td)
        check(os.path.exists(os.path.join(td, "BENCH_r00.json")),
              "zoo bert: the publish wrote no BENCH file")
    log(f"zoo (c) BERT-base seq 128 batch 16: sma_ms_per_step "
        f"{row['sma_ms_per_step']}, sma_gns_ms_per_step "
        f"{row['sma_gns_ms_per_step']}, gns_overhead_pct "
        f"{row['gns_overhead_pct']}, losses {row['losses']} on {card}")
    out["bert"] = row
    bert_state = {k: v.detach() for k, v in
                  models["sma"][0].state_dict().items()}
    del models
    torch.cuda.empty_cache()
    cifar = convergence_cv.run_cifar(ZOO_CIFAR_STEPS)
    check(cifar["real_data"] is False
          and math.isfinite(cifar["test_accuracy"]),
          f"zoo cifar: {cifar}")
    log(f"zoo (d) ResNet-18 on synthetic CIFAR, {cifar['steps']} steps: "
        f"test accuracy {cifar['test_accuracy']}, "
        f"{cifar['train_seconds']} s on {card}")
    out["cifar"] = cifar
    torch.cuda.empty_cache()
    zoo_helpers(torch, bert_state, card)
    del bert_state
    torch.cuda.empty_cache()
    log(f"zoo phase {time.perf_counter() - t0:.1f} s")
    return out


def k2_bound(kernel, n_pad, h, v_pad):
    """(bound_ms, bound_by, flops, bytes) of one K2 launch on these
    padded operands: each input read once, each output written once;
    flops are the logits products (2 n h v) plus dw's or dx's own
    product, against the bf16 tensor-core peak; residual_d's
    elementwise work (~6 f32 operations an element) against the f32
    peak."""
    nv = n_pad * v_pad
    row = 4 * n_pad                                  # one f32/int32 a row
    xw = 2 * n_pad * h + 2 * h * v_pad + 4 * v_pad + row   # x, W, b, t
    if kernel == "fwd":
        nbytes, flops, peak = xw + 2 * row + 2 * nv, 2 * n_pad * h * v_pad, \
            PEAK_BF16_FLOPS
    elif kernel == "residual_d":
        nbytes, flops, peak = 2 * 2 * nv + 2 * row + 4 * v_pad + 4, 6 * nv, \
            PEAK_F32_FLOPS
    elif kernel == "dw":
        nbytes, flops, peak = xw + row + 4 + 2 * h * v_pad + 4 * v_pad, \
            4 * n_pad * h * v_pad, PEAK_BF16_FLOPS
    else:
        nbytes, flops, peak = xw + row + 4 + 2 * n_pad * h, \
            4 * n_pad * h * v_pad, PEAK_BF16_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes)


def phase_timing_k2(torch, fc):
    """Each K2 kernel per launch at the training shape beside its bound,
    its plain version and the cuBLAS products the same work contains
    (timed only; the port never calls them in place of a kernel)."""
    x, w, b, t, scale = k2_inputs(torch, fc)
    n_pad, v_pad = x.shape[0], w.shape[1]
    _, lse, _ = fc.plain_fwd(x, w, b, t, False)
    logits, _, _ = fc.fused_ce_fwd(x, w, b, t, True)
    out = {}
    runs = {
        "fwd": (lambda i: fc.fused_ce_fwd(x, w, b, t, True),
                lambda i: fc.plain_fwd(x, w, b, t, True),
                [lambda i: x @ w]),
        # in place over the same buffer each launch: the bytes and the
        # work are the same whatever the values
        "residual_d": (lambda i: fc.fused_ce_residual_d(scale, logits, lse,
                                                        t),
                       lambda i: fc.plain_residual_d(scale, logits, lse, t),
                       None),
        "dw": (lambda i: fc.fused_ce_dw(scale, x, w, b, t, lse),
               lambda i: fc.plain_dw(scale, x, w, b, t, lse),
               [lambda i: x @ w, lambda i: x.t() @ logits]),
        "dx": (lambda i: fc.fused_ce_dx(scale, x, w, b, t, lse),
               lambda i: fc.plain_dx(scale, x, w, b, t, lse),
               [lambda i: x @ w, lambda i: logits @ w.t()]),
    }
    fwd_nores = time_cuda(torch, lambda i: fc.fused_ce_fwd(x, w, b, t,
                                                           False), 5)
    for name, (kern, plain, lib) in runs.items():
        ms = time_cuda(torch, kern, 5)
        plain_ms = time_cuda(torch, plain, 2)
        lib_ms = (sum(time_cuda(torch, f, 5) for f in lib)
                  if lib is not None else None)
        bound_ms, bound_by, flops, nbytes = k2_bound(name, n_pad, K2_H,
                                                     v_pad)
        out[name] = (ms, plain_ms, lib_ms, bound_ms, bound_by)
        log(f"timing K2 {name:10s} {ms:.4f} ms/launch; bound "
            f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B, {flops} flop); "
            f"plain {plain_ms:.4f} ms; library "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
            f"{1e-12 * flops / (ms * 1e-3):.1f} TFLOP/s, "
            f"{1e-9 * nbytes / (ms * 1e-3):.1f} GB/s achieved")
    log(f"timing K2 fwd without the residual (recompute forward) "
        f"{fwd_nores:.4f} ms/launch")
    log("timing K2 library: fwd = x @ W (bf16 cuBLAS); dw = x @ W + x^T @ "
        "d; dx = x @ W + d @ W^T; residual_d has no single PyTorch call "
        "for softmax - onehot written over its input with column sums: "
        "null")
    del logits
    torch.cuda.empty_cache()
    return out


def k1_bound(kernel, b, t, h, d, causal, window, dtype="bfloat16"):
    """(bound_ms, bound_by, flops, bytes) of one K1 launch on `dtype`
    inputs: the largest of three times. Bytes: each input read once and
    each output written once ([B, T, h, d] tensors of `dtype`, f32 [B*h,
    T] lse and delta): fwd reads q, k, v and writes o and lse; dq reads
    q, k, v, o, dO and lse and writes dq and delta; dkv reads q, k, v,
    dO, lse and delta and writes dk and dv. Operations: the products on
    the visible pairs (`flash_attention_flops`' count, 2 d FLOPs a pair a
    product): fwd q.k^T and p.v; dq q.k^T, dO.v^T and ds.k; dkv those two
    score products, p^T.dO and ds^T.q — bf16 against the bf16
    tensor-core peak; f32 against the lesser of two ways to keep f32's
    precision: FMA at the f32 rate outside the tensor cores, or split
    TF32, three tf32 products each, at `PEAK_TF32_FLOPS`. Exponentials:
    one a visible pair in each kernel (p = exp(s - m) or exp(s - lse)),
    at `PEAK_EXP_S`; at a small head dim they outlast the products.
    `bound_by` names the largest."""
    from kungfu_tpu_torch.ops.flash import flash_attention_flops

    itemsize = 4 if dtype == "float32" else 2
    seq = itemsize * b * t * h * d              # one [B, T, h, d]
    row = 4 * b * h * t                         # one f32 [B*h, T]
    pair_product = flash_attention_flops(b, t, h, d, causal, window) // 2
    pairs = flash_attention_flops(b, t, h, 1, causal, window) // 4
    nbytes, flops = {
        "fwd": (4 * seq + row, 2 * pair_product),
        "dq": (6 * seq + 2 * row, 3 * pair_product),
        "dkv": (6 * seq + 2 * row, 4 * pair_product)}[kernel]
    ops = (min(flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_FLOPS)
           if dtype == "float32" else flops / PEAK_BF16_FLOPS)
    times = {"bytes": nbytes / PEAK_BYTES_S, "operations": ops,
             "exponentials": pairs / PEAK_EXP_S}
    by = max(times, key=times.get)
    return 1e3 * times[by], by, flops, nbytes


def phase_timing_k1(torch, fl, tags=("a", "b")):
    """Each K1 kernel per launch at the `K1_SHAPES` named by `tags` (the
    smoke's (a) and (b); `benchmarks/kernel_ab.py` adds (c), the d-128
    kernels), cycling over four
    input sets (4 x 4 x 12.6 MB at (a): L2's 50 MB holds none of a
    launch's inputs from its previous visit), beside its bound, its plain
    version and the library yardstick scaled_dot_product_attention: its
    forward, and its backward alone (the graph is built outside the
    profiled window and kept with retain_graph), which computes dq, dk
    and dv together and so stands beside dq + dkv. Every time is device
    time per call (`time_device`). SDPA's backend is named as its
    dispatch picks it (and as the backward's autograd node names it),
    with every backend's time when forced. SDPA is timed only; the port
    never calls it. Uses only the wrappers and plain versions of
    `ops.flash`, so `benchmarks/kernel_ab.py` can time an older
    checkout's K1 with it. Returns {shape: {kernel: (ms, plain_ms,
    bound_ms, bound_by), "sdpa": {"fwd": ms, "bwd": ms, "bwd_node":
    str, "fwd_backend": {...}, "bwd_backend": {...}}}}."""
    import torch.nn.functional as F

    out = {}
    for tag in tags:
        b, t, h, d, causal, window = K1_SHAPES[tag]
        sets = []
        for seed in range(4):
            q, k, v, do = k1_inputs(torch, b, t, h, d, 10 + seed)
            o, lse = fl.flash_fwd(q, k, v, causal, None, window)
            _, delta = fl.flash_dq(q, k, v, o, lse, do, causal, None, window)
            sets.append((q, k, v, do, o, lse, delta))
        runs = {
            "fwd": (lambda x: fl.flash_fwd(x[0], x[1], x[2], causal, None,
                                           window),
                    lambda x: fl.plain_fwd(x[0], x[1], x[2], causal, None,
                                           window)),
            "dq": (lambda x: fl.flash_dq(x[0], x[1], x[2], x[4], x[5], x[3],
                                         causal, None, window),
                   lambda x: fl.plain_dq(x[0], x[1], x[2], x[4], x[5], x[3],
                                         causal, None, window)),
            "dkv": (lambda x: fl.flash_dkv(x[0], x[1], x[2], x[3], x[5],
                                           x[6], causal, None, window),
                    lambda x: fl.plain_dkv(x[0], x[1], x[2], x[3], x[5],
                                           x[6], causal, None, window)),
        }
        res = {}
        for name, (kern, plain) in runs.items():
            ms = time_device(torch, lambda i: kern(sets[i % 4]), 40)
            plain_ms = time_device(torch, lambda i: plain(sets[0]), 2)
            bound_ms, bound_by, flops, nbytes = k1_bound(name, b, t, h, d,
                                                         causal, window)
            res[name] = (ms, plain_ms, bound_ms, bound_by)
            log(f"timing K1 ({tag}) {name:4s} {ms:.4f} ms/launch on the "
                f"device; bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, "
                f"{flops} flop); plain {plain_ms:.4f} ms; "
                f"{1e-12 * flops / (ms * 1e-3):.1f} TFLOP/s, "
                f"{1e-9 * nbytes / (ms * 1e-3):.1f} GB/s achieved")
        # SDPA on contiguous [B, h, T, d] copies of the same values (its
        # own layout); the window as a boolean band mask (is_causal
        # cannot express it)
        mask = None
        if window is not None:
            pos = torch.arange(t, device=DEVICE)
            mask = (pos[:, None] >= pos[None, :]) & \
                (pos[:, None] - pos[None, :] <= window)
        lib = [[x.transpose(1, 2).contiguous().requires_grad_()
                for x in st[:4]] for st in sets]
        is_causal = causal and mask is None

        def sdpa(x):
            return F.scaled_dot_product_attention(
                x[0], x[1], x[2], attn_mask=mask, is_causal=is_causal)

        def sdpa_fwd(i):
            with torch.no_grad():
                return sdpa(lib[i % 4])

        def sdpa_bwd():
            """The backward alone: the four graphs are built here, under
            whatever backend the caller forces, outside the window."""
            outs = [sdpa(x) for x in lib]

            def bwd(i):
                x = lib[i % 4]
                return torch.autograd.grad(outs[i % 4], x[:3], x[3],
                                           retain_graph=True)
            bwd.node = outs[0].grad_fn.name()
            return bwd

        sdpa_fwd.inputs = tuple(x.detach() for x in lib[0][:3]) + (
            mask, is_causal)
        lib_fwd = time_device(torch, sdpa_fwd, 40)
        bwd = sdpa_bwd()
        lib_bwd, node = time_device(torch, bwd, 40), bwd.node
        del bwd
        res["sdpa"] = {"fwd": lib_fwd, "bwd": lib_bwd, "bwd_node": node}
        for key, fn, make, inputs in (
                ("fwd_backend", sdpa_fwd, None, None),
                ("bwd_backend", None, sdpa_bwd,
                 tuple(lib[0][:3]) + (mask, is_causal))):
            picked, forced = sdpa_backends(torch, fn, make, inputs)
            res["sdpa"][key] = {"picked": picked, "forced": forced}
        pair = res["dq"][0] + res["dkv"][0]
        log(f"timing K1 ({tag}) library sdpa forward {lib_fwd:.4f} ms, "
            f"backward alone {lib_bwd:.4f} ms ({res['sdpa']['bwd_node']}) "
            f"against dq + dkv {pair:.4f} ms ({pair / lib_bwd:.2f}x); mask "
            f"{'band' if mask is not None else 'is_causal'}; backends "
            f"{json.dumps({k: v for k, v in res['sdpa'].items() if 'backend' in k})}")
        out[tag] = res
        del sets, lib
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the seq phase: the sequence axis (ring and Ulysses through K1) and K1's
# cases beyond bf16 at head dims 64 and 128
# ---------------------------------------------------------------------------


def _close(torch, got, ref, dtype):
    """max |got - ref| and whether every element is within TOL[dtype]."""
    atol, rtol = TOL[dtype]
    err = (got.float() - ref.float()).abs()
    return float(err.max()), bool((err <= atol + rtol * ref.float().abs())
                                  .all())


def _bounded(torch, got, ref, bound, relative):
    """max |got - ref| and whether every element is within `bound` (a
    `kernel_error_bounds` entry), plus 2**-8 |ref| where `relative` (the
    rounding of a bf16 output: o, dq, dk, dv)."""
    err = (got.float() - ref.float()).abs()
    lim = bound + (2.0 ** -8 * ref.float().abs() if relative else 0.0)
    return float(err.max()), bool((err <= lim).all())


def k1_held(torch, fl, x, causal, window):
    """Each K1 kernel's outputs against its plain versions on the same
    inputs `x` = (q, k, v, dO, o, lse, dq, delta, dk, dv): an f32 kernel,
    whatever its family (SIMT or tf32), within TOL["float32"] of the
    plain version; a bf16 kernel (the wgmma family at every head dim)
    within `kernel_error_bounds` of the plain version in f32 (the wgmma
    kernels round p and ds to bf16 before the second product). dq and dkv get the kernels' own (o, lse) and delta.
    Returns {kernel: (max_abs_err, every element within)}."""
    q, k, v, do, o, lse, dq, delta, dk, dv = x
    dtype = str(q.dtype).split(".")[-1]
    f = [y.float() for y in (q, k, v, do)]
    out = {}
    for kernel, got in (("fwd", (o, lse)), ("dq", (dq, delta)),
                        ("dkv", (dk, dv))):
        bf16 = dtype == "bfloat16"
        ins = f if bf16 else (q, k, v, do)
        if kernel == "fwd":
            ref = fl.plain_fwd(*ins[:3], causal, None, window)
        elif kernel == "dq":
            ref = fl.plain_dq(*ins[:3], o, lse, ins[3], causal, None, window)
        else:
            ref = fl.plain_dkv(*ins[:3], ins[3], lse, delta, causal, None,
                               window)
        names = {"fwd": ("o", "lse"), "dq": ("dq", "delta"),
                 "dkv": ("dk", "dv")}[kernel]
        if bf16:
            # the bound at the (o, lse) the kernel was given: the plain
            # forward's own for fwd, the fwd kernel's for dq and dkv
            bound = fl.kernel_error_bounds(
                *f[:3], *(ref if kernel == "fwd" else (o, lse)), f[3],
                causal, None, window)
            res = [_bounded(torch, a, r, bound[n], n in ("o", "dq", "dk",
                                                         "dv"))
                   for a, r, n in zip(got, ref, names)]
        else:
            res = [_close(torch, a, r, dtype if n in ("o", "dq", "dk", "dv")
                          else "float32")
                   for a, r, n in zip(got, ref, names)]
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        out[kernel] = (max(e for e, _ in res),
                       finite and all(ok for _, ok in res))
    return out


def k1_label(fl, dtype, d, kernel):
    """The kernels line's family label of K1 `kernel` in `dtype` at head
    dim `d` off bf16 d 64/128: ``"simt"``, ``"tf32"`` (the f32 kernels
    in split TF32), ``"padded"`` (the wgmma kernel of D 64 or 128) or
    ``"d256"`` (the wgmma kernel of D 256), with ``".copy"`` where the
    wrapper reaches it through a zero-padded copy (bf16 at d % 8 != 0).
    Reads `fl.route`, so an older checkout's `ops.flash` (no tf32 family)
    labels too."""
    if fl.route(dtype, d, kernel) == "tf32":
        return "tf32"
    dd = fl.wgmma_dim(dtype, d, kernel)
    if dd is None:
        return "simt"
    return ("d256" if dd == 256 else "padded") + (".copy" if d % 8 else "")


def k1_new_cases(torch, fl):
    """(d) every new case of K1 on the card against its plain versions on
    the same inputs (`k1_held`: the f32 kernels, SIMT or tf32, within
    TOL, the padded wgmma kernels within `kernel_error_bounds`), and a
    second launch
    bitwise equal: `K1_NEW` in each of `K1_NEW_MODES`, then one fold
    launch of B*H > 65535 (within `kernel_error_bounds`, which covers
    both families). Returns {(kernel, dtype, `k1_label`): max_abs_err}."""
    errs = {}
    b, t, h = K1_NEW_SHAPE
    for dtype, d in K1_NEW:
        dt = getattr(torch, dtype)
        family = {n: fl.route(dt, d, n) for n in ("fwd", "dq", "dkv")}
        g = torch.Generator(device=DEVICE).manual_seed(d)
        q, k, v, do = (torch.randn(b, t, h, d, generator=g, device=DEVICE)
                       .to(dt) for _ in range(4))
        for mode, (causal, window) in K1_NEW_MODES.items():
            runs = []
            for _ in range(2):
                o, lse = fl.flash_fwd(q, k, v, causal, None, window)
                dq, delta = fl.flash_dq(q, k, v, o, lse, do, causal, None,
                                        window)
                dk, dv = fl.flash_dkv(q, k, v, do, lse, delta, causal, None,
                                      window)
                runs.append((o, lse, dq, delta, dk, dv))
            torch.cuda.synchronize()
            check(all(torch.equal(a, c) for a, c in zip(*runs)),
                  f"K1 {dtype} d={d} {mode}: a second launch differs")
            held = k1_held(torch, fl, (q, k, v, do) + runs[0], causal,
                           window)
            for kernel, (err, ok) in held.items():
                check(ok, f"K1 {kernel} {dtype} d={d} {mode} "
                      f"({family[kernel]}): outside its tolerance "
                      f"(max_abs_err {err:.3e})")
                key = (kernel, dtype, k1_label(fl, dt, d, kernel))
                errs[key] = max(errs.get(key, 0.0), err)
        log(f"seq (d) K1 {dtype} d={d}: fwd, dq, dkv in {sorted(K1_NEW_MODES)}"
            f" within their tolerances (f32: TOL[float32], bf16: "
            f"kernel_error_bounds), second launch bitwise; route "
            f"{json.dumps(family)}")
    # B * H = 66000: the grid folds B * H into its first dimension
    b, t, h, d = K1_FOLD
    g = torch.Generator(device=DEVICE).manual_seed(3)
    q, k, v, do = (torch.randn(b, t, h, d, generator=g, device=DEVICE)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fl.flash_fwd(q, k, v, True)
    dq, dk, dv = fl.flash_bwd(q, k, v, o, lse, do, True)
    o2, _ = fl.flash_fwd(q, k, v, True)
    torch.cuda.synchronize()
    check(torch.equal(o, o2), "K1 fold: a second launch differs")
    rows = lse.reshape(b, h, t)
    worst = 0.0
    for lo in (0, b - 50):
        sl = slice(lo, lo + 50)
        f = [x[sl].float() for x in (q, k, v, do)]
        ls = rows[sl].reshape(-1, t)
        ro, rlse = fl.plain_fwd(*f[:3], True)
        rdq, _ = fl.plain_dq(*f[:3], o[sl].float(), ls, f[3], True)
        bound = fl.kernel_error_bounds(*f[:3], o[sl], ls, f[3], True)
        for name, got, ref in (("o", o[sl], ro), ("lse", ls, rlse),
                               ("dq", dq[sl], rdq)):
            err, ok = _bounded(torch, got, ref, bound[name], name != "lse")
            check(ok, f"K1 fold {name}: outside the bound (max_abs_err "
                  f"{err:.3e})")
            worst = max(worst, err)
    check(bool(torch.isfinite(dk).all() and torch.isfinite(dv).all()),
          "K1 fold: non-finite dk/dv")
    family = {n: fl.route(torch.bfloat16, d, n)
              for n in ("fwd", "dq", "dkv")}
    log(f"seq (d) K1 fold B={b} H={h} (B*H {b * h} > 65535) T={t} d={d} "
        f"bf16 ({json.dumps(family)}): o, lse, dq within "
        f"kernel_error_bounds on rows 0..49 and {b - 50}..{b - 1} "
        f"(max_abs_err {worst:.3e}), second launch bitwise")
    del q, k, v, do, o, lse, dq, dk, dv
    torch.cuda.empty_cache()
    return errs


def seq_k1(spec: dict, seq_rank: int) -> int:
    """K1's launches a rank a step, per kernel, in the seq phase's run
    `spec`: Ulysses one a layer (one flash call over the full sequence
    for H / P heads); the ring one a layer a visible hop — every hop
    without the mask (BERT), and under GPT's causal mask the r + 1 hops
    at or below the diagonal of seq rank r."""
    if spec["attention"] == "ulysses":
        return LAYERS
    return LAYERS * (seq_rank + 1 if spec["model"] == "gpt"
                     else spec["mesh"][1])


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


_SEQ_REFERENCES: dict = {}


def seq_reference(torch, spec, attention, names, dtype=None):
    """One process on the card over the whole global batch of `spec`:
    the step-1 loss (before any update) and the gradients of `names`,
    with `attention` (GPT: flash or local; BERT: local) and the compute
    `dtype` (None: the run's, bf16). Runs of the same model, batch and
    settings (the GPT ring's and Ulysses') share one reference run."""
    from kungfu_tpu_torch.parallel import long_context as lc

    key = (spec["model"], spec.get("size"), spec["seq_len"], spec["batch"],
           attention, dtype, tuple(names))
    if key in _SEQ_REFERENCES:
        return _SEQ_REFERENCES[key]
    model = lc.build_model(spec["model"], spec.get("size", "small"),
                           spec["seq_len"], attention, False, DEVICE,
                           dtype=dtype)
    if spec["model"] == "bert":
        names = [n.replace("SeqParallelAttention_0",
                           "MultiHeadDotProductAttention_0") for n in names]
    tokens = lc.batch(spec["model"], spec["batch"], spec["seq_len"]).to(
        DEVICE)
    loss = lc.reference_loss(spec["model"], model, tokens)
    loss.backward()
    params = dict(model.named_parameters())
    grads = [params[n].grad.float().cpu() for n in names]
    _SEQ_REFERENCES[key] = float(loss.detach()), grads
    del model, params, loss
    torch.cuda.empty_cache()
    return _SEQ_REFERENCES[key]


def phase_seq(torch, fl, card: str) -> dict:
    """The seq phase (see the module docstring); returns the K1 launches
    of its main paths and (d)'s errors."""
    from kungfu_tpu_torch.benchmarks.flash_eff import \
        measure_flash_efficiency
    from kungfu_tpu_torch.benchmarks.lm import measure_lm_rate
    from kungfu_tpu_torch.dryrun import dryrun
    from kungfu_tpu_torch.parallel import long_context as lc

    t0 = time.perf_counter()
    grads_dir = os.path.join(HERE, "build", "seq_grads")
    os.makedirs(grads_dir, exist_ok=True)
    rows = lc.run(SEQ_RANKS, SEQ_SPECS, DEVICE, grads_dir=grads_dir,
                  timeout=600)
    log(f"seq (a-c): {len(rows)} runs x ranks in "
        f"{time.perf_counter() - t0:.1f} s; {SEQ_RANKS} ranks share one "
        f"card ({card}) over gloo: their speeds are not multi-card speeds")
    totals = {"fwd": 0, "dq": 0, "dkv": 0}
    for spec in SEQ_SPECS:
        mine = sorted((r for r in rows if r["run"] == spec["name"]),
                      key=lambda r: r["rank"])
        check(len(mine) == SEQ_RANKS, f"seq {spec['name']}: {len(mine)} "
              f"ranks reported")
        for r in mine:
            n = seq_k1(spec, r["coords"][1]) * spec["steps"]
            losses = r["losses"]
            check(all(math.isfinite(x) for x in losses),
                  f"seq {spec['name']} rank {r['rank']}: losses {losses}")
            check(losses[-1] < losses[0], f"seq {spec['name']} rank "
                  f"{r['rank']}: the loss did not fall {losses}")
            check(losses == mine[0]["losses"], f"seq {spec['name']}: the "
                  f"ranks' averaged losses differ")
            want = {"fwd": n, "dq": n, "dkv": n, "plain": 0}
            check(r["k1"] == want and r["untiled"] == 0,
                  f"seq {spec['name']} rank {r['rank']}: K1 launches "
                  f"{r['k1']} (untiled {r['untiled']}), expected {want}")
            for key in totals:
                totals[key] += r["k1"][key]
            ex = r["exchange"]
            ex_ms = sum(v["ms"] for v in ex.values())
            ex_b = sum(v["bytes"] for v in ex.values())
            staged = sum(v["staged_bytes"] for v in ex.values())
            med = sorted(r["step_ms"])[len(r["step_ms"]) // 2]
            mean = sum(r["step_ms"]) / len(r["step_ms"])
            log(f"seq {spec['name']} rank {r['rank']} {r['coords']}: "
                f"{med:.1f} ms/step (median of {r['step_ms']}), "
                f"{r['tokens_per_s']:.1f} tokens/s [4 ranks share one "
                f"card]; exchange a step {ex_ms:.1f} ms (mean; "
                f"{100 * ex_ms / mean:.1f} % of the mean step), "
                f"{ex_b / 1e6:.1f} "
                f"MB, staged {staged / 1e6:.1f} MB through pinned host "
                f"memory: {json.dumps({k: {f: round(x, 2) for f, x in v.items()} for k, v in ex.items()})}; "
                f"K1 launches {r['k1']}; peak "
                f"{r['peak_mem_gb']:.2f} GB; losses {losses}")
        # step 1 against one process over the whole batch
        sample = torch.load(os.path.join(grads_dir,
                                          f"{spec['name']}-grads.pt"))
        names = list(sample)
        step1 = mine[0]["losses"][0]
        # the reference run and a second correct run, whose gap to it is
        # the noise of the comparison
        if spec["model"] == "gpt":
            ref_loss, ref_g = seq_reference(torch, spec, "flash", names)
            alt_loss, alt_g = seq_reference(torch, spec, "local", names)
            ref_name, alt_name = "flash", "local"
        else:
            ref_loss, ref_g = seq_reference(torch, spec, "local", names)
            alt_loss, alt_g = seq_reference(torch, spec, "local", names,
                                            torch.float32)
            ref_name, alt_name = "local", "local f32"
        loss_tol = max(2 * abs(alt_loss - ref_loss),
                       SEQ_LOSS_FLOOR[spec["model"]] * abs(ref_loss))
        check(abs(step1 - ref_loss) <= loss_tol,
              f"seq {spec['name']}: step-1 loss {step1} against one "
              f"process's {ref_name} {ref_loss} (tolerance {loss_tol})")
        for name, ref, alt in zip(names, ref_g, alt_g):
            err, noise = _rel(sample[name], ref), _rel(alt, ref)
            tol = max(2 * noise, SEQ_GRAD_FLOOR)
            log(f"seq {spec['name']} grad {name}: rel L2 to one process's "
                f"{ref_name} {err:.3e} ({alt_name} vs {ref_name} "
                f"{noise:.3e}; tolerance {tol:.3e})")
            check(err <= tol, f"seq {spec['name']} grad {name}: "
                  f"{err:.3e} > {tol:.3e}")
        log(f"seq {spec['name']}: step-1 loss {step1:.6f}, one process "
            f"{ref_name} {ref_loss:.6f}, {alt_name} {alt_loss:.6f} "
            f"(tolerance {loss_tol:.3e})")
    out = {"seq": totals}
    out["new_case_errs"] = k1_new_cases(torch, fl)
    # (e) the tiny GPT (d 16) through the benchmark's entry point
    torch.cuda.synchronize()
    fl.reset_launches()
    rate, meta = measure_lm_rate("tiny", attention="flash")
    torch.cuda.synchronize()
    probe = meta.get("flash_kernel", {}).get("launches", {})
    k1 = {n: c - probe.get(n, 0) for n, c in fl.LAUNCHES.items()}
    simt = {k: c - probe.get(k.split(".")[0], 0)
            for k, c in fl.SIMT_LAUNCHES.items()}
    steps = len(meta["losses"])
    want = {"fwd": 2 * steps, "dq": 2 * steps, "dkv": 2 * steps,
            "plain": 0}
    # fwd, dq and dkv on the wgmma kernels padded to 64: none SIMT
    check(k1 == want and not any(simt.values()),
          f"seq (e): K1 launches {k1} / SIMT {simt} (probe {probe}), "
          f"expected {want} and none on the SIMT family")
    check(all(math.isfinite(x) for x in meta["losses"])
          and meta["losses"][-1] < meta["losses"][0],
          f"seq (e): losses {meta['losses']}")
    log(f"seq (e) measure_lm_rate('tiny', attention='flash') (d 16, bf16, "
        f"B {meta['per_data_batch']} T {meta['seq']}): {rate:.1f} tok/s, "
        f"{meta['step_time_ms']:.2f} ms/step; K1 {k1}, SIMT {simt}")
    out["tiny"] = {n: k1[n] for n in ("fwd", "dq", "dkv")}
    # (e') the flash benchmark in f32 at its default shape (B 8, T 1024,
    # h 12, d 64, causal): the f32 path, fwd, dq and dkv on the tf32
    # family, no SIMT launch; (e'''') the same at head dim 128 (B 4, h
    # 8): fwd, dq and dkv on the SIMT family, no tf32 launch
    three = {f"{n}.float32" for n in ("fwd", "dq", "dkv")}
    for tag, bench, name in (("e'", {"dtype": "float32"}, "f32"),
                             ("e''''", K1_F32_D128_BENCH, "f32d128")):
        fl.reset_launches()
        meta = measure_flash_efficiency(**bench)
        torch.cuda.synchronize()
        simt, tf32 = dict(fl.SIMT_LAUNCHES), dict(fl.TF32_LAUNCHES)
        on_tf32 = tag == "e'"
        check(fl.LAUNCHES["plain"] == 0
              and set(tf32 if on_tf32 else simt) == three
              and not (simt if on_tf32 else tf32),
              f"seq ({tag}): K1 launches {fl.LAUNCHES}, SIMT {simt}, tf32 "
              f"{tf32}, expected fwd, dq and dkv on "
              f"{'tf32' if on_tf32 else 'SIMT'} and none on the other")
        log(f"seq ({tag}) measure_flash_efficiency(dtype='float32', "
            f"head_dim={meta['head_dim']}) (B {meta['batch']} T "
            f"{meta['seq']} h {meta['heads']}, causal): fwd "
            f"{meta['fwd_ms']:.3f} ms, fwd+bwd {meta['fwdbwd_ms']:.3f} ms, "
            f"{meta['fwdbwd_tflops']:.2f} TFLOP/s (slope-timed); route "
            f"{meta['plan']['route']}; SIMT {simt}; tf32 {tf32}")
        out[name] = {n: fl.LAUNCHES[n] for n in ("fwd", "dq", "dkv")}
    # (e'') the bf16 flash benchmark at head dim 256 (Gemma's): fwd, dq
    # and dkv on the D-256 wgmma kernels; (e''') at head dim 252 (d % 8
    # != 0): the same kernels on a zero-padded copy. No SIMT launch
    for tag, bench in (("e''", K1_D256_BENCH), ("e'''", K1_D252_BENCH)):
        fl.reset_launches()
        meta = measure_flash_efficiency(**bench)
        torch.cuda.synchronize()
        simt = dict(fl.SIMT_LAUNCHES)
        check(fl.LAUNCHES["plain"] == 0 and not simt
              and all(fl.LAUNCHES[n] > 0 for n in ("fwd", "dq", "dkv")),
              f"seq ({tag}): K1 launches {fl.LAUNCHES}, SIMT {simt}, "
              f"expected every kernel launched and none on the SIMT "
              f"family")
        log(f"seq ({tag}) measure_flash_efficiency(dtype='bfloat16', "
            f"head_dim={bench['head_dim']}) (B {meta['batch']} T "
            f"{meta['seq']} h {meta['heads']}, causal): fwd "
            f"{meta['fwd_ms']:.3f} ms, fwd+bwd {meta['fwdbwd_ms']:.3f} ms, "
            f"{meta['fwdbwd_tflops']:.2f} TFLOP/s (slope-timed); route "
            f"{meta['plan']['route']}; K1 {dict(fl.LAUNCHES)}, SIMT {simt}")
        out[f"d{bench['head_dim']}"] = {n: fl.LAUNCHES[n]
                                        for n in ("fwd", "dq", "dkv")}
    # (f) the dry run's phase 2 on the card's ranks (gloo, staged): the
    # reference's phase runs the plain ring (no use_flash), so it
    # launches no K1
    res = dryrun(4, DEVICE, phases=(2,))
    line = res["lines"][-1]
    check(line.startswith("dryrun: phase 2 (sp) n=4 mesh=2x2 device=cuda"),
          f"seq (f): {line}")
    log(f"seq (f) on the card's ranks (gloo, staged): {line}")
    log(f"[{time.perf_counter() - T_START:.0f} s] seq phase took "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def phase_timing_k1_simt(torch, fl):
    """K1 off bf16 d 64/128 at `K1_SIMT_TIMING`'s shapes, the main path's,
    each kernel on the family its wrapper picks (read from
    `SIMT_LAUNCHES` and, where the checkout has it, `TF32_LAUNCHES`, so
    an older checkout's `ops.flash` runs here too, for
    `benchmarks/kernel_ab.py`): first held to its plain versions on the
    same inputs (`k1_held`: an f32 kernel within TOL, a bf16 one within
    `kernel_error_bounds`), then timed per launch by device time, cycling
    over four input sets, beside the bound (`k1_bound`: its inputs'
    bytes; its products at the card's peak for the input type — f32 the
    lesser of FMA outside the tensor cores and split TF32's three tf32
    products, bf16 the tensor-core rate; its exponentials), the plain
    version and SDPA on the same shape (forward, with its largest error
    against the plain forward; backward alone against dq + dkv), with the
    backend SDPA picks. Returns {tag: {kernel: (ms, plain_ms, bound_ms,
    bound_by), "family": {kernel: "simt" | "tf32" | "wgmma"}, "sdpa":
    {...}, "errs": {kernel: max_abs_err}}}."""
    import torch.nn.functional as F

    def counts():
        return (sum(fl.SIMT_LAUNCHES.values()),
                sum(getattr(fl, "TF32_LAUNCHES", {}).values()))

    def launched_on(run):
        """The family whose count `run` (one launch) raised."""
        simt, tf32 = counts()
        out = run()
        after = counts()
        return out, ("simt" if after[0] > simt else
                     "tf32" if after[1] > tf32 else "wgmma")

    out = {}
    for tag, (b, t, h, d) in K1_SIMT_TIMING.items():
        dtype = tag.split(".")[0]
        dt = getattr(torch, dtype)
        peak_name = ("the lesser of FMA at the f32 peak outside the tensor "
                     "cores and 3 tf32 products at the tf32 tensor-core "
                     "peak" if dt == torch.float32 else
                     "the bf16 tensor-core peak")
        sets = []
        for seed in range(4):
            g = torch.Generator(device=DEVICE).manual_seed(20 + seed)
            q, k, v, do = (torch.randn(b, t, h, d, generator=g,
                                       device=DEVICE).to(dt)
                           for _ in range(4))
            o, lse = fl.flash_fwd(q, k, v, True)
            _, delta = fl.flash_dq(q, k, v, o, lse, do, True)
            sets.append((q, k, v, do, o, lse, delta))
        q, k, v, do, o, lse, delta = sets[0]
        family = {}
        _, family["fwd"] = launched_on(lambda: fl.flash_fwd(q, k, v, True))
        (dq, _), family["dq"] = launched_on(
            lambda: fl.flash_dq(q, k, v, o, lse, do, True))
        (dk, dv), family["dkv"] = launched_on(
            lambda: fl.flash_dkv(q, k, v, do, lse, delta, True))
        torch.cuda.synchronize()
        held = k1_held(torch, fl, (q, k, v, do, o, lse, dq, delta, dk, dv),
                       True, None)
        errs = {}
        for kernel, (err, ok) in held.items():
            check(ok, f"K1 {kernel} ({family[kernel]}) {dtype} at B={b} "
                  f"T={t} h={h} d={d} causal: outside its tolerance "
                  f"(max_abs_err {err:.3e})")
            errs[kernel] = err
        log(f"K1 {dtype} at the main path's B={b} T={t} h={h} d={d} "
            f"causal: families {json.dumps(family)}; fwd, dq, dkv within "
            f"their tolerances (f32: TOL[float32], bf16: "
            f"kernel_error_bounds) of plain (max_abs_err "
            f"{json.dumps({n: float(f'{e:.3e}') for n, e in errs.items()})})")
        del dq, dk, dv
        runs = {
            "fwd": (lambda x: fl.flash_fwd(x[0], x[1], x[2], True),
                    lambda x: fl.plain_fwd(x[0], x[1], x[2], True)),
            "dq": (lambda x: fl.flash_dq(x[0], x[1], x[2], x[4], x[5],
                                         x[3], True),
                   lambda x: fl.plain_dq(x[0], x[1], x[2], x[4], x[5], x[3],
                                         True)),
            "dkv": (lambda x: fl.flash_dkv(x[0], x[1], x[2], x[3], x[5],
                                           x[6], True),
                    lambda x: fl.plain_dkv(x[0], x[1], x[2], x[3], x[5],
                                           x[6], True)),
        }
        res = {"family": family}
        for name, (kern, plain) in runs.items():
            ms = time_device(torch, lambda i: kern(sets[i % 4]), 20)
            plain_ms = time_device(torch, lambda i: plain(sets[0]), 2)
            bound_ms, bound_by, flops, nbytes = k1_bound(
                name, b, t, h, d, True, None, dtype)
            res[name] = (ms, plain_ms, bound_ms, bound_by)
            log(f"timing K1 {family[name]} {dtype} (B={b} T={t} h={h} d={d} "
                f"causal) {name:4s} {ms:.4f} ms/launch on the device; bound "
                f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B, {flops} flop "
                f"at {peak_name}, one exponential a visible pair at "
                f"{PEAK_EXP_S:.2e}/s); {ms / bound_ms:.1f}x bound; plain "
                f"{plain_ms:.4f} ms")
        lib = [[x.transpose(1, 2).contiguous().requires_grad_()
                for x in st[:4]] for st in sets]

        def sdpa(x):
            return F.scaled_dot_product_attention(x[0], x[1], x[2],
                                                  is_causal=True)

        def sdpa_fwd(i):
            with torch.no_grad():
                return sdpa(lib[i % 4])

        sdpa_fwd.inputs = tuple(x.detach() for x in lib[0][:3]) + (None,
                                                                    True)
        outs = [sdpa(x) for x in lib]

        def sdpa_bwd(i):
            x = lib[i % 4]
            return torch.autograd.grad(outs[i % 4], x[:3], x[3],
                                       retain_graph=True)

        lib_fwd = time_device(torch, sdpa_fwd, 20)
        lib_bwd = time_device(torch, sdpa_bwd, 20)
        picked, forced = sdpa_backends(torch, sdpa_fwd)
        # SDPA's own precision at this dtype: its forward on the first set
        # against the plain forward (f32 arithmetic) on the same values
        ro, _ = fl.plain_fwd(*(x.float() for x in sets[0][:3]), True)
        lib_err = float((sdpa_fwd(0).transpose(1, 2).float() - ro).abs()
                        .max())
        del ro
        res["sdpa"] = {"fwd": lib_fwd, "bwd": lib_bwd, "backend": picked,
                       "forced": forced, "bwd_node": outs[0].grad_fn.name(),
                       "max_abs_err": lib_err}
        res["errs"] = errs
        pair = res["dq"][0] + res["dkv"][0]
        log(f"timing K1 {tag} library sdpa forward {lib_fwd:.4f} ms "
            f"({picked}; forced {json.dumps(forced)}; "
            f"{res['fwd'][0] / lib_fwd:.1f}x library; max_abs_err "
            f"{lib_err:.3e} against the plain forward, the kernel's "
            f"{errs['fwd']:.3e}), backward "
            f"alone {lib_bwd:.4f} ms ({res['sdpa']['bwd_node']}) against "
            f"dq + dkv {pair:.4f} ms ({pair / lib_bwd:.1f}x library)")
        out[tag] = res
        del sets, lib, outs
        torch.cuda.empty_cache()
    return out


def serve_requests(vocab, seed=7):
    """12 requests: prompts of 32..512 tokens, 4 of them sharing a
    64-token prefix, 64 new tokens each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(0, vocab, 64)]
    reqs = []
    for i in range(12):
        n = int(rng.integers(32, 513))
        body = [int(t) for t in rng.integers(0, vocab, n)]
        if i % 3 == 0:                      # requests 0, 3, 6, 9
            body = prefix + body[:max(n - 64, 1)]
        reqs.append((i, body, 64))
    return reqs


def serve(engine, reqs, max_iters=20000):
    """Admit as slots and blocks allow, step until every request is
    done; a preempted request is re-admitted with prompt + generated.
    Returns {request: tokens}."""
    queue = deque(reqs)
    prompts = {r: p for r, p, _ in reqs}
    budget = {r: m for r, _, m in reqs}
    out = {r: [] for r, _, _ in reqs}
    done = set()
    for _ in range(max_iters):
        while queue and engine.can_admit(len(queue[0][1])):
            r, p, m = queue.popleft()
            tok, fin = engine.admit(r, p, m)
            if tok is not None:
                out[r].append(tok)
            if fin:
                done.add(r)
        emitted, preempted = engine.step()
        for r, (tok, fin) in emitted.items():
            out[r].append(tok)
            if fin:
                done.add(r)
        for r in preempted:
            queue.append((r, prompts[r] + out[r], budget[r] - len(out[r])))
        if not queue and not engine.live():
            break
    check(done == set(out), f"requests not finished: "
          f"{sorted(set(out) - done)}")
    return out


def phase_serve(torch, pa, model, kernel):
    from kungfu_tpu_torch.serve import DecodeEngine

    eng = DecodeEngine(model, max_batch=BATCH, block_tokens=BT,
                       max_len=MAX_LEN, kernel=kernel, share_prefix=True,
                       prefill_chunk=256)
    eng.warm()
    reqs = serve_requests(model.config.vocab_size)
    torch.cuda.synchronize()
    pa.reset_launches()                     # counts of THIS run only
    t0 = time.perf_counter()
    out = serve(eng, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pa.LAUNCHES)
    scheme = eng.kernel
    check(scheme in ("resident", "stream"), f"engine resolved {scheme!r}")
    check(all(len(t) == 64 for t in out.values()), "a request came back "
          "with other than 64 tokens")
    check(all(0 <= x < model.config.vocab_size for t in out.values()
              for x in t), "token outside the vocabulary")
    check(launches[scheme] == model.config.num_layers * eng.decode_iters
          and eng.decode_iters > 0,
          f"{scheme} launched {launches[scheme]} times over "
          f"{eng.decode_iters} decode steps")
    check(launches["plain"] == 0, f"plain version ran {launches['plain']} "
          f"times on the card")
    other = "stream" if scheme == "resident" else "resident"
    check(launches[other] == 0, f"{other} launched in a {scheme} run")
    stats = {
        "kernel": kernel, "scheme": scheme, "launches": launches[scheme],
        "decode_steps": eng.decode_iters, "decode_tokens": eng.decode_tokens,
        "decode_ms_per_step": 1e3 * eng.decode_s / eng.decode_iters,
        "decode_tok_s": eng.decode_tokens / eng.decode_s,
        "prefill_s": eng.prefill_s, "prefill_chunks": eng.prefill_chunks,
        "wall_s": wall, "requests": len(out),
    }
    check(eng.pool.check_invariants() == [], "allocator invariants")
    check(eng.pool.blocks_in_use == 0, "blocks leaked after the run")
    log("serve " + json.dumps(stats))
    return out, stats


def phase_parity(torch):
    """f32, 2 layers at GPT-2-small width: kernel paths == functional
    oracle == dense-cache gpt_generate, token for token."""
    import numpy as np

    from kungfu_tpu_torch.models import gpt_generate
    from kungfu_tpu_torch.serve import DecodeEngine, build_lm
    from kungfu_tpu_torch.serve import paged

    model = build_lm("small", max_position=MAX_LEN, dtype=torch.float32,
                     num_layers=2, seed=3)
    rng = np.random.default_rng(11)
    vocab = model.config.vocab_size
    reqs = [(i, [int(t) for t in rng.integers(0, vocab, n)], 32)
            for i, n in enumerate((17, 40, 200, 300))]
    runs = {}
    for kernel in ("functional", "auto", "stream"):
        eng = DecodeEngine(model, max_batch=BATCH, block_tokens=BT,
                           max_len=MAX_LEN, kernel=kernel,
                           share_prefix=True, prefill_chunk=256)
        runs[kernel] = serve(eng, reqs)
    dense = {r: gpt_generate(model, torch.tensor([p], device=DEVICE),
                             m)[0, len(p):].tolist() for r, p, m in reqs}
    for kernel in ("auto", "stream"):
        check(runs[kernel] == runs["functional"],
              f"f32 tokens: kernel={kernel} differs from functional")
    check(runs["functional"] == dense,
          "f32 tokens: engine differs from gpt_generate")
    # one decode step's logits, kernel vs functional, on the same state
    eng = DecodeEngine(model, max_batch=BATCH, block_tokens=BT,
                       max_len=MAX_LEN, kernel="auto")
    for r, p, _ in reqs:
        eng.admit(r, p, 8)
    order = eng.live()
    pad = BATCH - len(order)
    tables = torch.as_tensor(eng.pool.batch_tables(order, eng.max_blocks,
                                                   pad_rows=pad),
                             device=DEVICE)
    lengths = torch.as_tensor(eng.pool.batch_lengths(order, pad_rows=pad),
                              device=DEVICE)
    tokens = torch.zeros(BATCH, dtype=torch.int32, device=DEVICE)
    logit = {}
    for kernel in ("functional", "resident", "stream"):
        pk, pv = eng.pool_k.clone(), eng.pool_v.clone()
        logit[kernel] = paged.decode_step(model, pk, pv, tables, lengths,
                                          tokens, kernel=kernel)
    for kernel in ("resident", "stream"):
        err = float((logit[kernel] - logit["functional"]).abs().max())
        log(f"parity f32 decode_step logits {kernel} vs functional "
            f"max_abs_err {err:.3e}")
        check(err < 1e-3, f"f32 logits {kernel}: {err}")
    log(f"parity f32 tokens equal: auto ({eng.kernel}), stream, "
        f"functional, gpt_generate; {len(reqs)} requests x 32 tokens")


def time_cuda(torch, fn, iters):
    for _ in range(3):
        fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_device(torch, fn, iters):
    """Device time per call of `fn`: the union of the intervals of the
    kernels its `iters` calls launch (CUPTI through torch.profiler),
    over `iters`. Unlike `time_cuda` it leaves out the card's idle gaps
    while the host prepares the next call, which dominate a kernel of a
    few microseconds launched from Python."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn(0)
    torch.cuda.synchronize()
    # on the H100 a session has come back without device events where the
    # same calls, in the same order of phases, recorded them: such a
    # session runs again, at most three times in all
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans:
            break
    check(spans, "the profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / iters / 1e3


def sdpa_backends(torch, fn, make=None, inputs=None):
    """The backend SDPA's dispatch picks for `inputs` (default
    `fn.inputs`: q, k, v, mask and, optionally, is_causal) and each
    backend's ms per call when forced (None where it refuses them):
    ``(picked, {backend: ms})``. With `make`, the function timed under
    each forced backend is ``make()``, called inside the forcing (a
    backward's graphs are built there, so the forced backend is the one
    the graph records)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v, mask, *rest = fn.inputs if inputs is None else inputs
    names = {int(b.value): n for n, b in SDPBackend.__members__.items()}
    try:
        picked = names.get(int(torch._fused_sdp_choice(
            q, k, v, mask, 0.0, bool(rest and rest[0]))), "unknown")
    except (AttributeError, RuntimeError, TypeError):
        picked = "unknown"
    forced = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                forced[name] = time_device(
                    torch, make() if make is not None else fn, 4 * LAYERS)
        except RuntimeError:
            forced[name] = None
    return picked, forced


#: K3's timing shapes (8 rows each): full 1023-token rows (decode at
#: max_len) and the serve phase's mixed lengths (prompts of 32..512
#: tokens plus up to 64 new ones: 32..576)
K3_SHAPES = {"full": [MAX_LEN - 1] * BATCH,
             "mixed": [32, 109, 187, 265, 343, 420, 498, 576]}


def phase_timing(torch, pa):
    """K3 per launch at each of `K3_SHAPES`, cycling over the 12
    layers' pools (~300 MB, so L2 holds none of a launch's K/V from the
    previous visit), beside the byte bound of the blocks this run's
    lengths make visible, the plain version and the library yardstick:
    scaled_dot_product_attention on K/V gathered beforehand (up to the
    longest row), with the boolean mask and, at full rows, where the
    mask is all true, without it; each with the backend SDPA's dispatch
    picks and every backend's time when forced. Every time is device
    time per call (`time_device`); the kernels' back-to-back times with
    the host's gaps (`time_cuda`) are kept as "<scheme>_wall". Uses only
    `paged_attention`, `paged_attention_reference` and
    `paged_traffic_bytes`, so `benchmarks/kernel_ab.py` can time an
    older checkout's K3 with it. Returns {shape: {"resident": ms,
    "stream": ms, "resident_wall": ms, "stream_wall": ms, "plain": ms,
    "sdpa_mask": ms, "sdpa_nomask": ms or None, "sdpa_backend": {...},
    "bound_ms": ms, "bound_by": str}}."""
    import torch.nn.functional as F

    dtype = torch.bfloat16
    kp, vp, nbp1 = pools(torch, dtype)
    g = torch.Generator(device=DEVICE).manual_seed(4)
    q = torch.randn(BATCH, HEADS, HEAD_DIM, generator=g,
                    device=DEVICE).to(dtype)
    isz = q.element_size()
    out = {}
    for shape, lengths in K3_SHAPES.items():
        tables, lens = tables_for(torch, lengths)
        nbytes = (pa.paged_traffic_bytes(lengths, BT, HEADS, HEAD_DIM, isz)
                  + 2 * q.numel() * isz + tables.numel() * 4
                  + lens.numel() * 4)
        flops = 4 * sum(n + 1 for n in lengths) * HEADS * HEAD_DIM
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
        res = {"bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        for scheme in ("resident", "stream"):
            def k3(i, s=scheme):
                return pa.paged_attention(
                    q, kp, vp, tables, lens, block_base=(i % LAYERS) * nbp1,
                    scheme=s)
            res[scheme] = time_device(torch, k3, 20 * LAYERS)
            res[f"{scheme}_wall"] = time_cuda(torch, k3, 20 * LAYERS)
        res["plain"] = time_device(
            torch, lambda i: pa.paged_attention_reference(
                q, kp, vp, tables, lens, block_base=(i % LAYERS) * nbp1),
            2 * LAYERS)
        # the library yardstick: SDPA over K/V gathered beforehand
        nblk = max(lengths) // BT + 1
        t = nblk * BT
        idx = tables.long()[:, :nblk]
        kk = [kp[idx + l * nbp1].reshape(BATCH, t, HEADS, HEAD_DIM)
              .transpose(1, 2).contiguous() for l in range(LAYERS)]
        vv = [vp[idx + l * nbp1].reshape(BATCH, t, HEADS, HEAD_DIM)
              .transpose(1, 2).contiguous() for l in range(LAYERS)]
        mask = (torch.arange(t, device=DEVICE)[None, :]
                <= lens.long()[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        variants = {"sdpa_mask": mask}
        if bool(mask.all()):
            variants["sdpa_nomask"] = None
        res["sdpa_nomask"] = None
        res["sdpa_backend"] = {}
        for name, m in variants.items():
            def sdpa(i, m=m):
                return F.scaled_dot_product_attention(
                    q4, kk[i % LAYERS], vv[i % LAYERS], attn_mask=m)
            sdpa.inputs = (q4, kk[0], vv[0], m)
            res[name] = time_device(torch, sdpa, 20 * LAYERS)
            picked, forced = sdpa_backends(torch, sdpa)
            res["sdpa_backend"][name] = {"picked": picked, "forced": forced}
        for scheme in ("resident", "stream"):
            log(f"timing K3 ({shape}) {scheme:8s} {res[scheme]:.4f} ms/launch"
                f" on the device ({res[scheme + '_wall']:.4f} back to back "
                f"from the host); bound {res['bound_ms']:.4f} ms "
                f"({res['bound_by']}: {nbytes} B, {flops} flop); plain "
                f"{res['plain']:.4f} ms; {1e-6 * nbytes / res[scheme]:.1f} "
                f"GB/s achieved")
        for name in variants:
            log(f"timing K3 ({shape}) library {name} {res[name]:.4f} ms on "
                f"{t} gathered positions; backends "
                f"{json.dumps(res['sdpa_backend'][name])}")
        out[shape] = res
        del kk, vv
    del kp, vp
    torch.cuda.empty_cache()
    return out


def build_all(_build, names):
    """One nvcc per library, all started together, beside libkf's g++
    build (one compiler per source, `native.library`); prints the
    time and the compiler's register, spill and warning lines."""
    from kungfu_tpu_torch.native import library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as pool:
        libkf = pool.submit(library)
        texts = dict(zip(names, pool.map(_build.build, names)))
        libkf_path = libkf.result()
    log(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(names)} and "
        f"libkf ({libkf_path.name}), in parallel)")
    for name, text in texts.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "error", "warning")):
                log(f"  {name}: {line.strip()}")
        _build.load(name)


def bytecode_cache() -> None:
    """Cache compiled bytecode under ``build/pycache`` for this process
    and every process it starts. Where the environment forbids writing
    bytecode (``PYTHONDONTWRITEBYTECODE``) and the installed packages
    ship none, each new interpreter compiles torch from its sources
    again: 7.3 s of an 8.8 s ``import numpy, torch`` on the H100's host.
    Runs before torch is first imported."""
    prefix = os.path.join(HERE, "build", "pycache")
    os.makedirs(prefix, exist_ok=True)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ.setdefault("PYTHONPYCACHEPREFIX", prefix)
    sys.dont_write_bytecode = False
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]


def main() -> int:
    bytecode_cache()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from kungfu_tpu_torch.ops import _build
    from kungfu_tpu_torch.ops import flash as fl
    from kungfu_tpu_torch.ops import fused_ce as fc
    from kungfu_tpu_torch.ops import paged_attn as pa
    from kungfu_tpu_torch.ops import stream as st
    from kungfu_tpu_torch.serve import build_lm

    card = card_line()
    # the smoke runs on one card: name it for every runner it starts, so
    # their slot mapping (`run.job.visible_cards`) reads the variable
    # instead of starting nvidia-smi
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions'
    torch.backends.cudnn.allow_tf32 = False         # f32 products exact
    build_all(_build, ["paged_attn", "fused_ce", "flash", "stream"])

    errs = phase_kernel(torch, pa)
    k2_errs = phase_kernel_k2(torch, fc)
    k1_errs = phase_kernel_k1(torch, fl)
    r1_err = phase_kernel_r1(torch, st)
    log(f"[{time.perf_counter() - T_START:.0f} s] kernel phases done")
    model = build_lm("small", max_position=MAX_LEN, seed=0)
    log(f"model: GPT-2-small {model.config}")
    served = {}
    for kernel in ("auto", "stream"):
        out, stats = phase_serve(torch, pa, model, kernel)
        served[stats["scheme"]] = (out, stats)
    agree = sum(a == b for r in served["resident"][0]
                for a, b in zip(served["resident"][0][r],
                                served["stream"][0][r]))
    total = sum(len(t) for t in served["resident"][0].values())
    log(f"serve bf16 resident vs stream token agreement {agree}/{total}")
    del model
    torch.cuda.empty_cache()
    phase_parity(torch)
    trained = {}
    for variant, attention in (("residual", "local"),
                               ("recompute", "local"),
                               ("residual", "flash")):
        trained[f"{variant}/{attention}"] = phase_train(
            torch, fc, fl, variant, attention)
        torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - T_START:.0f} s] train phases done")
    resnet = phase_resnet(torch)
    torch.cuda.empty_cache()
    r1_launches = phase_roofline(torch, st)
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - T_START:.0f} s] resnet and roofline done")
    elastic = phase_elastic(torch, card)
    log(f"[{time.perf_counter() - T_START:.0f} s] elastic done")
    adaptive = phase_adaptive(torch, fc, fl, card)
    log(f"[{time.perf_counter() - T_START:.0f} s] adaptive done")
    tier = phase_serve_tier(card, served["resident"][0])
    log(f"[{time.perf_counter() - T_START:.0f} s] serve-tier done")
    scen = phase_scenario(card)
    log(f"[{time.perf_counter() - T_START:.0f} s] scenario done")
    bench = phase_benchmarks(torch, pa, card)
    log(f"[{time.perf_counter() - T_START:.0f} s] benchmarks done")
    zoo = phase_zoo(torch, card)
    log(f"[{time.perf_counter() - T_START:.0f} s] zoo done")
    seq = phase_seq(torch, fl, card)
    log(f"[{time.perf_counter() - T_START:.0f} s] seq done")
    local, flash = trained["residual/local"], trained["residual/flash"]
    log(f"train local vs flash (residual CE, this call): "
        f"{local['step_time_ms']:.2f} vs {flash['step_time_ms']:.2f} "
        f"ms/step, {local['tokens_per_sec']:.1f} vs "
        f"{flash['tokens_per_sec']:.1f} tok/s, MFU {local['mfu']} vs "
        f"{flash['mfu']}, peak memory {local['peak_mem_gb']:.2f} vs "
        f"{flash['peak_mem_gb']:.2f} GB; flash kernel efficiency "
        f"{json.dumps(flash['flash_kernel'])}")
    k3_times = phase_timing(torch, pa)
    k2_times = phase_timing_k2(torch, fc)
    k1_times = phase_timing_k1(torch, fl)
    simt_times = phase_timing_k1_simt(torch, fl)
    r1_times = phase_timing_r1(torch, st)
    log(f"[{time.perf_counter() - T_START:.0f} s] timing done")

    kernels = []
    # full rows; library: SDPA without the mask (all true at full rows:
    # the same function), the masked call and the mixed shape in the log
    full = k3_times["full"]
    for scheme in ("resident", "stream"):
        kernels.append({
            "name": f"paged_attn.{scheme}", "route": "cuda",
            "source": "kungfu_tpu_torch/csrc/paged_attn.cu",
            "replaces": REPLACES[scheme],
            "launches": served[scheme][1]["launches"],
            "serve_tier_launches": tier[scheme],
            "scenario_launches": scen[f"paged_attn.{scheme}"],
            "benchmarks_launches": bench[scheme],
            "max_abs_err": errs[(scheme, "bfloat16")],
            "ms": full[scheme], "plain_ms": full["plain"],
            "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
            "library_ms": full["sdpa_nomask"],
        })
    for name in ("fwd", "residual_d", "dw", "dx"):
        ms, plain_ms, lib_ms, bound_ms, bound_by = k2_times[name]
        kernels.append({
            "name": f"fused_ce.{name}", "route": "cuda",
            "source": "kungfu_tpu_torch/csrc/fused_ce.cu",
            "replaces": K2_REPLACES[name],
            "launches": sum(m["launches"][name] for m in trained.values()),
            "elastic_launches": elastic.get(f"fused_ce.{name}", 0),
            "adaptive_launches": adaptive.get(f"fused_ce.{name}", 0),
            "scenario_launches": scen.get(f"fused_ce.{name}", 0),
            "max_abs_err": k2_errs[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms,
        })
    sdpa = k1_times["a"]["sdpa"]
    for name in ("fwd", "dq", "dkv"):
        # shape (a), the training shape. library_ms: SDPA's forward for
        # fwd; for dq and dkv SDPA's backward, the one PyTorch call that
        # computes their function: it returns dq, dk and dv together, so
        # its time stands on both rows as the time of the pair
        ms, plain_ms, bound_ms, bound_by = k1_times["a"][name]
        row = {
            "name": f"flash.{name}", "route": "cuda",
            "source": "kungfu_tpu_torch/csrc/flash.cu",
            "replaces": K1_REPLACES[name],
            "launches": trained["residual/flash"]["k1_launches"][name],
            "elastic_launches": elastic[f"flash.{name}"],
            "adaptive_launches": adaptive[f"flash.{name}"],
            "scenario_launches": scen[f"flash.{name}"],
            "seq_launches": seq["seq"][name],
            "max_abs_err": k1_errs[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sdpa["fwd"] if name == "fwd" else sdpa["bwd"],
            "library_call": "scaled_dot_product_attention " + (
                f"forward ({sdpa['fwd_backend']['picked']})" if name == "fwd"
                else f"backward ({sdpa['bwd_node']})"),
        }
        if name != "fwd":
            row["library_ms_is_pair"] = "flash.dq + flash.dkv"
        kernels.append(row)
    # K1 off bf16 d 64/128, a row per kernel, family label and dtype: the
    # f32 kernels launched on the main path by the flash benchmark (e') (d
    # 64: the tf32 fwd, dq and dkv) and (e'''') (d 128: the SIMT fwd, dq
    # and dkv); the wgmma fwd, dq and dkv padded to 64 by the tiny
    # GPT's training (e) (d 16); the D-256 wgmma fwd, dq and dkv by the
    # bf16 flash benchmark at d 256 (e''); the same kernels on the
    # zero-padded copy by the same at d 252 (e'''), timed with the copies
    # and slices the wrappers add (label ".copy"). Each timed at its shape in
    # K1_SIMT_TIMING, the main path's (the first shape that runs it),
    # with the launches of the run at that shape; max_abs_err over (d)'s
    # cases of that kernel, label and dtype and the main path's shape;
    # library: SDPA as for the wgmma rows
    launched = {"float32": seq["f32"], "bfloat16": seq["tiny"],
                "bfloat16.d256": seq["d256"], "bfloat16.d252": seq["d252"],
                "float32.d128": seq["f32d128"]}
    seen = set()
    for tag, timed in simt_times.items():
        dtype = tag.split(".")[0]
        d = K1_SIMT_TIMING[tag][3]
        lib = timed["sdpa"]
        labels = {n: k1_label(fl, getattr(torch, dtype), d, n)
                  for n in ("fwd", "dq", "dkv")}
        check(all(timed["family"][n] == (labels[n] if labels[n] in (
                      "simt", "tf32") else "wgmma") for n in labels),
              f"K1 {tag}: launched {timed['family']}, routed {labels}")
        for name in ("fwd", "dq", "dkv"):
            label = labels[name]
            row_name = f"flash.{name}.{label}.{dtype}"
            if row_name in seen:
                continue
            seen.add(row_name)
            ms, plain_ms, bound_ms, bound_by = timed[name]
            row = {
                "name": row_name, "route": "cuda",
                "source": "kungfu_tpu_torch/csrc/flash.cu",
                "replaces": K1_REPLACES[name],
                "launches": launched[tag][name],
                "max_abs_err": max(
                    seq["new_case_errs"].get((name, dtype, label), 0.0),
                    timed["errs"][name]),
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib["fwd"] if name == "fwd" else lib["bwd"],
                "library_call": "scaled_dot_product_attention " + (
                    f"forward ({lib['backend']})" if name == "fwd"
                    else f"backward ({lib['bwd_node']})"),
                "shape": "B={} T={} h={} d={} causal".format(
                    *K1_SIMT_TIMING[tag]),
            }
            if label.endswith(".copy"):
                row["ms_includes"] = (
                    f"the zero-padded copies to {fl.tma_dim(d)} columns "
                    f"and the slice of the outputs to {d}")
            if name != "fwd":
                row["library_ms_is_pair"] = (
                    f"flash.dq.{labels['dq']}.{dtype} + "
                    f"flash.dkv.{labels['dkv']}.{dtype} at this shape")
            kernels.append(row)
    # torch.neg is R1's plain version and the one library call computing
    # the same function: plain_ms and library_ms are the same timing
    # (device time, as ms)
    kernels.append({
        "name": "stream.neg", "route": "cuda",
        "source": "kungfu_tpu_torch/csrc/stream.cu",
        "replaces": R1_REPLACES, "launches": r1_launches,
        "max_abs_err": r1_err, "ms": r1_times["ms"],
        "plain_ms": r1_times["plain_ms"],
        "bound_ms": r1_times["bound_ms"], "bound_by": "bytes",
        "library_ms": r1_times["plain_ms"],
    })
    log(f"resnet50 S-SGD: {resnet['images_per_sec']:.1f} images/s, "
        f"{resnet['step_time_ms']:.2f} ms/step (NCCL, one card)")
    log(f"zoo: vgg16 {zoo['vgg16']['images_per_sec']:.1f} images/s, "
        f"inception3 {zoo['inception3']['images_per_sec']:.1f} images/s, "
        f"BERT-base sma {zoo['bert']['sma_ms_per_step']} ms/step, "
        f"sma+gns {zoo['bert']['sma_gns_ms_per_step']} ms/step "
        f"({zoo['bert']['gns_overhead_pct']} %); no kernel of the port "
        f"on the zoo's path")
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was not launched on its path: {kernels}")
    # (b)'s workers run KF_SERVE_KERNEL=auto, the plan's resident scheme:
    # the stream scheme is not on the scenario's path
    scenario_path = ("paged_attn.resident", "fused_ce.fwd",
                     "fused_ce.residual_d", "flash.fwd", "flash.dq",
                     "flash.dkv")
    check(all(k["scenario_launches"] > 0 for k in kernels
              if k["name"] in scenario_path),
          f"a kernel of the scenario phase was not launched: {kernels}")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:                         # noqa: BLE001 — report, fail
        traceback.print_exc()
        sys.exit(1)
