#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (paddle_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --phases health,health_trip,fit_resume,transformer
                                     # phases 1-2, then only those named
    python3 chip_smoke.py --phases serve,serve_control
                                     # phases 1-2, 4-5 and 23
    python3 chip_smoke.py --phases observe
                                     # phases 1-2 and 24
    python3 chip_smoke.py --phases ps
                                     # phases 1-2 and 25
    python3 chip_smoke.py --phases dp
                                     # phases 1-2 and 26
    python3 chip_smoke.py --phases resnet_dp
                                     # phases 1-2 and 27

Phases, each of which raises (exit code != 0, with its traceback) on a
failure:

1. device   - the card's name, capability, and `nvidia-smi` name/power limit;
2. build    - build the hand-written kernels from csrc/ (timed);
3. kernels  - each kernel against its plain PyTorch version on the card, at
              the serving and training paths' shapes, fp32 and bf16, with
              kernel, plain, library and bound times and the design timed
              ("mma.sync" on the tensor cores, "mma.sync-3xtf32" for the
              fp32 flash kernels on the TF32 tensor cores, with the
              CUDA-core bound beside its own, "wgmma-tma" for the bf16 1x1
              conv and "wgmma-3xtf32" for the fp32 one, or "cuda-core";
              an empty kernel's time is the floor of any launch, stated
              beside each bound below it; the flash forward run twice, bit
              for bit, in fp32 at every serving prefill bucket 16-1,024
              and at L 1,000, 4,096 and D 128 L 4,096; the 1x1 conv at
              the 12 shapes of the ResNet step in fp32 and bf16, run
              twice, bit for bit, fp32 at Cin 2,048 also against fp64; the
              flash
              forward and split pair in bf16 also at L 1,000 and at D 128;
              the one-pass backward also at B 2 L 1,024 H 16 D 128, run
              twice (dk, dv bit for bit, dq within tolerance) and beside
              the split pair on the same inputs; paged attention's split
              into partitions, run twice, bit for bit) (the long path's
              layer norm, CE, flash forward and split backward's pair at
              its B 1 x 32,768 too, the attention plain versions one head
              at a time, the pair also against the one-pass kernel and
              twice, bit for bit); then, for correctness only, at the
              edges each kernel claims (ragged tails, Lk != Lq, D 8-128,
              ctx 0, page and partition boundaries, contexts past the
              block table, N up to 4096, V off the vector width, labels
              out of range, a NaN in the 1x1 conv's x or w);
4. serve    - GPT-2 small at full width (12 layers, hidden 768, 12 heads,
              vocab 50304, fp32, random weights from a seed) through two
              ServingEngine(max_batch=32, max_len=1024, page_size=16)s,
              decode_mode "eager" and "fused" (one CUDA graph per lane
              bucket and greedy or sampling variant, and per prompt
              bucket and variant for prefill, in one pool; the eager
              engine prefills op by op): 3 paired rounds,
              eager then fused, of 64 greedy requests of 32-512 prompt
              tokens plus two longer than 512, 32 new tokens each, every
              request's tokens bit for bit between the modes; then for
              each lane bucket W 1-32 exactly W requests, greedy and
              sampled (temperature 0.8, top_k 40, top_p 0.95, seeds
              from 0), tokens bit for bit between the modes; every run's
              launches exact (25 layer norms a forward, 12 flash
              forwards a prefill, 12 paged attentions a decode iteration,
              counted through replays), no plain version and no
              composition, every prefill's attention on the 3xTF32
              design; one fused iteration launches 25 + 12 through one
              replay; one graph per (W, variant) and per ("prefill",
              bucket, variant) used, none recaptured, each replayed as
              often as it was used again; one fused run on the engine's
              loop thread (start()/close()); TPOT p50/p99, TTFT p50/p99,
              tokens/s, host ms a decode iteration and a prefill, the
              prefill graphs' replays and the 960-token prompt's prefill
              wall ms per mode and round, device operations and ms a
              decode iteration at W 32 (torch.profiler), and the graph
              pool's bytes;
5. cpu      - the same weights on the CPU (plain versions) against the card:
              prefill logits and 8 teacher-forced decode steps for 2 requests;
6. train    - GPT-2 small at full width trained by
              jit.TrainStep(model, F.cross_entropy, AdamW(1e-4, wd 0.01),
              amp_dtype=bfloat16) at batch 8, sequence 1024 (the JAX
              package's bench_gpt2 configuration): 2 warm-up steps, then
              timed steps on one batch; the loss must fall, every training
              kernel must launch its expected count per step and no plain
              version may run; step ms, tokens/s and MFU;
7. train-cpu - the same weights in fp32 at batch 1, sequence 128, on the card
              and on the CPU: the loss, every parameter's gradient and every
              parameter after one TrainStep must agree;
8. resnet   - ResNet-50 (NHWC, fused BN, fused 1x1 conv + BN, 1000
              classes, random weights from a seed) trained by
              jit.TrainStep(model, F.cross_entropy, Momentum(0.1, 0.9),
              amp_dtype=bfloat16) at batch 128, 224x224 (the JAX package's
              bench_resnet50 configuration, NHWC without remat): 2 warm-up
              steps, then timed steps on one batch; the first update must
              lower the loss and every loss stay finite and below 3 times
              the first; each ResNet kernel must launch its expected count
              per step and no plain version may run, the 1x1 convs at the
              12 shapes of RESNET_CONV_SHAPES, all on the wgmma design;
              step ms, images/s and MFU;
9. resnet-cpu - ResNet-50 in fp32 at batch 2, 64x64 and at batch 8,
              128x128, one TrainStep on the card and on the CPU: loss,
              gradients, parameters after the step and running statistics
              must agree;
10. long    - GPT-2 small at full width on one 32,768-token sequence
              (max_position_embeddings 32,768, remat "full"), trained by
              the same TrainStep and AdamW: one warm-up step, then timed
              steps; the attention backward is the split dq / dk-dv pair;
              exact launches per step, no plain run, the first update must
              lower the loss; step ms, tokens/s, MFU and peak memory;
11. remat   - a 2-layer GPT-2 small at L 32,768, one step at each remat
              mode from the same weights: losses and gradients agree with
              remat "" and "full" peaks below "";
12. resnet-recompute - one ResNet-50 O2 step at b128 224x224 with
              recompute=True against the same step without it: the loss,
              every gradient and the running statistics (moved once)
              agree;
13. composed - each input that the reference composes in XLA and the
              port, on a card, in torch (fp16 layer norm, attention,
              cross-entropy and fused BN; a float mask and a 3-D bool
              mask, which the kernels' gate refuses; causal Lq > Lk; head
              dim 160): its entry's composition must run and none of its
              kernels, and output and gradients must agree with the same
              call on the CPU;
14. bert    - BERT-Base with a 2-way head on the pooled output (12
              layers, hidden 768, 12 heads, vocab 30522, dropout 0)
              trained by jit.TrainStep(model, F.cross_entropy, AdamW(1e-4),
              amp_dtype=bfloat16) at B 256, L 128 (the JAX package's
              bench_bert_base configuration): 2 warm-up steps, then timed
              steps on one batch; the loss must fall over the run (its
              first AdamW update raises it on this model) and every loss
              be finite; exact launches a step (layer norm 25 and its
              backward 25, flash forward 12 on mma.sync, one-pass backward
              12, CE 1 + 1),
              no plain run, no composition; step ms, samples/s, MFU and
              peak memory;
15. bert-cpu - the same model in fp32 at B 2, L 128, one TrainStep on the
              card and on the CPU: loss, gradients and parameters after the
              step agree (phase 7's tolerances);
16. ernie   - ErnieForPretraining(ErnieConfig.base()) under O2 bf16 at B 32,
              L 128 with knowledge-masked spans (the rest -100): the CE
              kernel at V 40,000, exact launches, the loss finite and lower
              after the update;
17. amp     - BERT-Base in the eager loop at B 32, L 128 under
              amp.auto_cast(level="O1"): bf16 (attention launches in bf16,
              layer norm and CE in fp32) and fp16 (attention composes,
              layer norm and CE in fp32), each loss against the fp32 loss
              of the same weights; GradScaler skips a step with an
              injected inf and backs off, on the card as on the CPU;
18. health  - the training-health sentinel on phase 6's step (GPT-2
              small, O2 bf16, AdamW(1e-4, wd 0.01), b8 s1024): health off
              and on (interval 1) in turns, 10 rounds of off, on, each 2
              warm-up and 6 timed steps, then interval 10 the same way
              (6 rounds of 20 timed steps); a run of steps is timed with
              one wait at its end, so the host may queue ahead as a
              training loop does: step ms off and on, the overhead (the
              median of the rounds') and its spread, the sentinel's host
              ms a step (forming, decoding, fetching), the groups, and the
              sentinel's device operations a fetched step (torch.profiler,
              a step with it against one without, which update alike); its
              loss must be the step's bit for bit, grad_norm and
              update_ratio within 1e-5 of direct readings, every value
              finite, the path's kernels launched and no plain version;
19. health_trip - NaN in one element of blocks.5's first layer-norm weight
              (the step's fp32 masters), one step: the sentinel trips with
              bad_param_groups ["blocks.5"], the replay names the layer-norm
              kernel's wrapper in blocks.5.ln1, the layer-norm kernel
              launches in the replay (no plain run), and
              health_nonfinite_total counts the sentinel and the eager trip;
20. fit_resume - hapi.Model(GPT-2 small).fit in fp32 (as Model builds its
              TrainStep) at b8 s1024 with the sentinel on, 8 steps:
              uninterrupted; with FaultTolerantCheckpoint(save_freq_steps=
              2, keep_last_n=2) and HealthMonitor(action="rollback") and a
              weight poisoned after step 5 (one rollback, to step 4); then
              the newest file truncated and a fresh fit(resume=) from other
              weights: the corrupt file skipped, the restored state and the
              first resumed loss bit for bit, later losses within
              FIT_LOSS_ATOL of the uninterrupted run; save and load seconds,
              file bytes, the fp32 step ms;
21. transformer - Transformer-base (nn.Transformer() at the reference's
              defaults: d_model 512, 8 heads, 6 + 6 layers, FFN 2048; a
              shared 37,000-token embedding tied to the output, sinusoidal
              positions) trained by jit.TrainStep(model, F.cross_entropy,
              Adam(0.9, 0.98, 1e-9) over NoamDecay(512, 4000),
              amp_dtype=bfloat16) at B 32, sources padded to 128 and
              targets to 112, with bool masks (key padding, and
              tril-and-padding in the decoder), residual dropout 0.1 and
              attention dropout 0: 2 warm-up and 8 timed steps; exact
              launches a step (masked forward 18 on mma.sync, masked
              one-pass 18, layer norm 30 and its backward 30, CE 1 + 1),
              no plain run or
              composition, the loss falls over the run; step ms, tokens/s
              padded and real, MFU and peak memory; then its fp32 step
              with every dropout 0 at B 2 on the card and on the CPU
              (phase 15's tolerances, the CPU's ReLU branches matched to
              the card's where the two round a pre-activation to
              opposite sides of 0);
22. resnet_fit - ResNet-50 (NHWC, 1000 classes) trained in fp32 through
              hapi.Model(net).prepare(Momentum(0.1, 0.9),
              F.cross_entropy).fit, as Model builds its step, at
              bench_resnet50's B 128, 224x224 on one repeated seeded batch,
              under PyTorch's default TF32 flags (cuDNN's allow_tf32 True):
              first the port's fp32 conv2d (stem 7x7/2, layer1 3x3)
              against the same call with the flag off, forward and
              gradients bit for bit; then 2 warm-up and 8 timed steps;
              exact launches a step, all 32 1x1 convs on "wgmma-3xtf32",
              no plain run or composition, the first update lowers the
              loss and every loss stays finite and below 3 times the
              first; step ms, images/s, MFU and peak memory;
23. serve_control - one fused engine at phase 4's widths: a swap to a
              second seeded weight set while 8 requests are in flight
              (the swap's pause; later requests' tokens equal a fresh
              engine's on the new weights bit for bit, every live
              parameter in its storage, no graph captured again); a
              rollback (the original tokens again); the canary's
              perplexity of a B 2 x T 128 probe under the live and the
              candidate weights (layer norm, flash forward and the CE
              forward counted, no plain run, the live weights untouched);
              restart() mid-decode (the requeued requests finish with the
              original tokens, no capture); suspension (EngineSuspended
              with its retry_after_s), the queue cap, shrink_pool(0.5) and
              restore_pool; the MemoryGovernor on torch.cuda.mem_get_info
              with its limit one byte under the bytes in use (shrink, then
              suspend) and then raised (resume, then restore);
24. observe - the observability plane: GPT-2 small fp32 through hapi
              Model.fit (b8 s1024, 12 steps) with PADDLE_TPU_METRICS_PORT=0
              and a ThroughputMonitor(window=4) writing JSONL (every record
              valid, the card's memory in it); from a client thread, while
              the fit waits at its sixth step: /healthz 200 "healthy",
              /metrics with the watchdog, compile and device-memory
              families, /snapshot with one train_step signature and no
              retrace, the graph capture and the kernel build in its
              compile attribution, then /profile?steps=2: after a lead-in
              step, the capture's Kineto trace holds exactly the launches
              the counters saw over its two steps, kernel by kernel (layer norm and its backward,
              flash forward, one-pass backward, CE forward and backward),
              and the two train_step spans' measured device time equals
              the trace's kernel, copy and set time within 2 %; the cap's
              timer finalizing a window from its own thread, the training
              thread's next step stopping Kineto; the monitor's and the
              server's cost, fits on and off in 3 paired rounds. Then a
              fused ServingEngine behind an ObservabilityServer: a
              Profiler(targets=[CPU, GPU]) window (a READY lead-in step,
              then 6 RecordEvent-spanned engine steps) whose trace holds
              every paged-attention launch of those steps (no graph
              captured in it), 429 at the queue limit, POST
              /generate's tokens equal to engine.generate's, /requests,
              /slo, /healthz's serving block, 503 with Retry-After while
              suspended;
25. ps      - Wide&Deep over the parameter server at bench.py's widths
              (B 512, 8 slots, ids uniform in [0, 1,000,000), dim 16, 13
              dense features, hidden 64; Adam 1e-3 on the dense tower,
              server SGD 0.05, BCE with logits, 8 seeded batches reused
              in turn), each part on a fresh table server: the eager loop
              (2 warm-up + 20 timed steps), sync HeterPSTrainStep over
              the same batches (its losses against the eager loop's within
              PS_LOSS_TOL, its dense step replaying a captured graph), 5
              sync steps on the CPU against the card's, an async probe
              (10 steps, flush), the pipelined step with a 32,768-row
              hot-row cache and prefetch (2 warm-up passes, 30 timed
              steps, 5 synced; stage times, hit rate, evictions,
              overflow, graph replays, peak memory; the cache's buffers on
              the card and every hit served by the gather there), and
              DeepFM's sync step against its eager loop; no kernel runs;
26. dp      - collective data parallelism: init_parallel_env() as world 1
              over NCCL, every collective on the card against the
              reference's one-rank answer; TrainStep(DataParallel(GPT-2
              small)) O2 b8 s1024 captured against TrainStep(GPT-2 small),
              6 steps under deterministic_steps, losses and every master,
              slot and buffer bit for bit, the bucketed all-reduces (and
              the label count's and the loss's) counted through every
              replay and NCCL's kernels seen in one replay under the
              profiler; a capture that fails after its all-reduces, then
              an all-reduce and the step captured again; the kernels at
              GPT-3 1.3B's shapes against their plain versions; GPT-3 1.3B
              (hidden 2048, 24 layers, 16 heads, L 2048, V 50,304) at full
              width and depth, remat "full", O2 bf16, AdamW, through
              TrainStep(DataParallel) captured at B 4 x L 2048 (2 warm-up
              + 6 timed steps: step ms, device busy, peak memory, tokens/s,
              MFU, exact launches, the first loss within 0.1 of ln V);
              then `python -m paddle_tpu_torch.distributed.launch
              --nproc_per_node 2` with PADDLE_DISTRI_BACKEND=gloo, both
              ranks on the card, GPT-2 small fp32 through the eager
              DataParallel loop (global batch 8, 4 a rank, x 1,024,
              AdamW, 3 steps) against one process over the global batch
              (DP_LOSS_ATOL, DP_PARAM_*), each rank's kernels counted and
              its plain counters 0;
27. resnet_dp - ResNet-50 data parallelism, every batch norm synchronized
              over the group: TrainStep(DataParallel(ResNet-50 NHWC)) O2
              bf16 b128 224x224 captured on a world-1 NCCL group against
              TrainStep(ResNet-50), 3 steps under deterministic_steps,
              losses and every master, slot and buffer bit for bit, exact
              launches (rows 10-13: 49 / 49 / 49 / 32 a step, no plain
              run), the collectives a step by kind through the replays
              (2 x 53 "bn_sync", the buckets, the label count and the
              loss); both captured steps timed in turns (step ms,
              images/s, device busy, NCCL kernels in a replay); then two
              gloo ranks on the card through the launcher, ResNet-50 fp32
              over a global batch of 32 (16 a rank; bench.py's 128 cut
              for time), 3 Momentum(0.1, 0.9) steps through the eager
              DataParallel loop against one process over the global
              batch, after the first step and the third, within
              RN_NOISE_MULT times the one process's distance with its
              batch reversed; and an fp16 BatchNorm2D(64, act="relu")
              over the two ranks (the composed route: counted in
              composed_stats, 2 "bn_sync") against one process;
28. report  - the `kernels` JSON line, the card's name and power limit, and
              the device JSON line last.

Every TrainStep above runs captured (one CUDA graph per batch signature,
replayed; launches counted through the replays). After each of phases 6,
8, 10, 14, 21 and 22 the path's captured step is timed against the same
step uncaptured (TrainStep._step_uncaptured) in 3 paired rounds, in turns
(step ms, host ms a step, device operations and busy ms of one profiled
step of each, the graph pool's bytes, peak memory: `paired_capture`), and
a capture gate (`capture_gate`) builds the step twice from the same
seeded weights, batches and generator state and runs it uncaptured, then
captured, for 10 steps (3 on the long path), under `deterministic_steps`
(the flash backward on the split pair, whose dq takes no atomics, and
cuDNN's deterministic algorithms, in both runs): the losses and every
master, optimizer slot and buffer must agree bit for bit, each run's
launches be exact a step with no plain run or composition, and each
(signature, variant) be captured once and replayed the other times; on
phases 6 and 8 two more uncaptured runs of 2 steps at the path's own
settings report whether the path repeats bit for bit at all. Phase 6b
(`capture_edges`): a loss_fn that calls .item() makes TrainStep raise,
naming the capture; dropout 0.1 inside remat "full" plus a dropout from
an explicit CUDA generator, captured against uncaptured over 4 steps,
bit for bit, the generators' states alike after.

Phase 3 also holds the flash kernels with their bool-mask operand (the
`*_masked` counters): the forward, one-pass backward and split pair
against their masked plain versions at phase 21's B 32, H 8, D 64
shapes (encoder L 128 with [B, 1, 1, L] key padding, decoder L 112 with
tril-and-padding [B, 1, L, L], cross-attention Lq 112 Lk 128), bf16 and
fp32, timed beside SDPA with the same bool attn_mask; the split pair at
B 1, L 32,768, H 12 with the last 2,768 keys padded away, against its
plain versions one head at a time; and, for correctness, every design
(bf16 and fp32 at D 64 and 128, fp32 at Lq <= 32, D 80 on CUDA cores)
with random [B, H, Lq, Lk] masks and whole rows masked, shared
[1, 1, Lq, Lk] masks, Lq != Lk, tails and the mask with causal: a row
with no visible key must give exactly 0 in out and dq and lse -inf,
nothing NaN, the forward and the split pair bit for bit twice.

Phase 3 also holds the layer norm's backward kernel against its plain
version (the composition it replaced) at the training paths' shapes:
R 8,192 N 768 bf16 (GPT O2) and fp32 (Model.fit), R 32,768 N 768 bf16 at
eps 1e-12 (BERT) and 1e-5 (long), R 4,096 N 512 bf16 (Transformer-base),
run twice, bit for bit, timed beside F.layer_norm's autograd backward;
every training path's exact launches count it (25 a step for GPT, BERT,
Model.fit and long, 26 for ERNIE, 30 for Transformer-base).

Phase 3 also holds the softmax CE pair (its designs: "ce-warp-rows", a
row of at most 512 classes (forward) or 256 (backward) held in
registers, and "ce-stream", a block a row or row segment) at every path's
shape: GPT b8 and Model.fit N 8,192 V 50,304, ResNet N 128 V 1,000, the
long path's N 32,768, BERT's N 256 V 2, ERNIE's N 4,096 V 40,000 and
Transformer-base's N 3,584 V 37,000; each launch's design held to the
wrapper's prediction (`fwd_design`, `bwd_design`) and each pair run twice,
bit for bit (`ce_pair`); at its edges (`check_ce_edges`: V 1, 2, 31, 33,
1,000 and 1,001, N 1, both sides of the crossing, rows off the 16-byte
boundary, labels out of range, a NaN row); and every path phase's CE
launches on their predicted designs (`ce_designs`).

Phase 3 also holds the ResNet kernels (fused BN forward, reduce and dx;
1x1 conv + statistics) at the ResNet-50 shapes, fp32 and bf16, and at
their edges, and the BERT and ERNIE steps' kernels: the flash forward and
one-pass backward at B 256, L 128, H 12, D 64, non-causal (bf16, and fp32
for correctness), the CE at N 256, V 2 and N 4,096, V 40,000, and layer
norm at R 32,768, N 768, eps 1e-12, bf16; attention bounds count L^2
(q, k) pairs when not causal, L(L + 1)/2 when causal.

Numerics: float32 matrix products run in full fp32
(torch.backends.cuda.matmul.allow_tf32 = False, and cuDNN's flag off
too), so the card and the CPU compute the same function; phase 22 runs
under PyTorch's defaults, where the port's fp32 conv2d switches cuDNN's
TF32 off inside each call. Needs one card and imports no JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# H100 SXM published peaks (dense): HBM 3.35 TB/s; fp32 on CUDA cores
# 67 TFLOP/s; bf16 on tensor cores 989 TFLOP/s; TF32 on tensor cores
# 495 TFLOP/s, of which the 3xTF32 split spends three products on each
# fp32 product: 165 TFLOP/s of fp32 work
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
#: the peak of a design whose operations run elsewhere than its type's
DESIGN_PEAK = {"mma.sync-3xtf32": 495e12 / 3, "wgmma-3xtf32": 495e12 / 3}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
OUT_DIR = "chiprun_out"


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes, flops, dtype, design=None):
    """Least time for the work: bytes over HBM rate vs ops over the peak
    of the design (DESIGN_PEAK) or else of the type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / DESIGN_PEAK.get(design, PEAK_FLOPS[dtype])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def design_bounds(nbytes, flops, dtype, design):
    """A row's bound_ms and bound_by at its design's peak and, for the
    fp32 forward on the TF32 tensor cores, the CUDA-core bound beside it
    (the same work at fp32's 67 TFLOP/s), labelled bound_cuda_core_ms."""
    bnd, by = bound_ms(nbytes, flops, dtype, design)
    out = dict(bound_ms=bnd, bound_by=by)
    if design in DESIGN_PEAK:
        out["bound_cuda_core_ms"] = bound_ms(nbytes, flops, dtype)[0]
    return out


def cuda_ms(fn, iters=20, reps=5, warmup=3, graph=True):
    """Mean device time of one fn() call. `iters` calls are captured in
    one CUDA graph and the graph is replayed `reps` times between two
    events, so the host's launch cost (which dominates a call of a few
    microseconds) does not enter the time. With graph=False (for calls
    that cannot be captured, such as a library backward through autograd)
    `iters * reps` calls run under torch.profiler and the time is the sum
    of their device kernels' times: back-to-back calls between events
    would read the host's cost of each autograd call instead."""
    if not graph:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        act = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            for _ in range(iters * reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        return us / 1e3 / (iters * reps)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def launch_floor_ms():
    """The card's floor for one launch: an empty kernel (one warp,
    csrc/layer_norm.cu pt_empty) timed as every kernel row is, from a
    replayed CUDA graph (cuda_ms)."""
    from paddle_tpu_torch import _native
    lib = _native.load()
    return cuda_ms(lambda: _native.check(lib.pt_empty(
        torch.cuda.current_stream().cuda_stream), "empty"))


def max_err(got, ref):
    return float((got.float() - ref.float()).abs().max())


def same_bits(a, c):
    """torch.equal on the bits, so NaN equals NaN of the same bits."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return torch.equal(a.view(ints[a.dtype]), c.view(ints[c.dtype]))


def launched_design(fn, want, names=("flash_attention",)):
    """fn's result, where fn launches each flash kernel of `names` once:
    the design each C entry reported (counted in `design_stats` under its
    name, masked launches apart) must be `want`, the wrapper's prediction
    (`fwd_design`, `bwd_design`)."""
    from paddle_tpu_torch.ops import kernels
    before = kernels.design_stats()
    res = fn()
    after = kernels.design_stats()
    for name in names:
        b, a = before.get(name, {}), after.get(name, {})
        ran = {d: n - b.get(d, 0) for d, n in a.items() if n != b.get(d, 0)}
        if ran != {want: 1}:
            raise AssertionError(f"{name}: launched {ran}, the wrapper "
                                 f"predicts {want}")
    return res


#: the split backward's two kernels
SPLIT = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")


# ----------------------------- phase 3: kernels -----------------------------


def check_layer_norm(dev, gen, rows_list, N, eps=1e-5,
                     dtypes=(torch.float32, torch.bfloat16)):
    """The layer-norm forward kernel against its plain version at epsilon
    `eps` (the shape string names it when it is not 1e-5), run twice, bit
    for bit."""
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    rows = []
    tag = "" if eps == 1e-5 else f" eps={eps:g}"
    for dtype in dtypes:
        for R in rows_list:
            x = torch.randn(R, N, device=dev, generator=gen).to(dtype)
            g = (1 + 0.1 * torch.randn(N, device=dev, generator=gen)).to(dtype)
            b = (0.1 * torch.randn(N, device=dev, generator=gen)).to(dtype)
            y = ln.layer_norm_fwd(x, g, b, eps)
            same = torch.equal(y, ln.layer_norm_fwd(x, g, b, eps))
            torch.cuda.synchronize()
            if not same:
                raise AssertionError(f"layer norm R={R} N={N} {dtype}: two "
                                     f"runs differ")
            err = max_err(y, ln.layer_norm_plain(x.float(), g.float(),
                                                 b.float(), eps))
            isz = x.element_size()
            bnd, by = bound_ms(2 * R * N * isz + 2 * N * isz, 8 * R * N,
                               dtype)
            rows.append(dict(
                kernel="layer_norm", dtype=str(dtype)[6:],
                shape=f"R={R} N={N}{tag}",
                max_abs_err=err, tol=TOL[dtype],
                ms=cuda_ms(lambda: ln.layer_norm_fwd(x, g, b, eps)),
                plain_ms=cuda_ms(lambda: ln.layer_norm_plain(x, g, b, eps)),
                library_ms=cuda_ms(lambda: torch.nn.functional.layer_norm(
                    x, (N,), g, b, eps)),
                bound_ms=bnd, bound_by=by))
    return rows


#: a layer-norm backward's dgamma and dbeta against their fp32 plain sums:
#: SUM_RTOL of the sum of the terms' magnitudes (ln_bwd_ratio; the sums run
#: in another order), plus, in bfloat16, one unit in the last place (the
#: fp32 sum rounded once)
LN_BWD_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}


def ln_bwd_ratio(ln, x, g, dy, eps, got):
    """Worst error / tolerance of the backward's (dx, dgamma, dbeta) `got`
    against the plain version on fp32 copies (its values before any
    rounding): dx to bwd_tol, dgamma and dbeta to elem_ratio over the
    magnitudes of their terms, |dy| (|x - mean| + |mean|) rstd and |dy|
    (LN_BWD_RTOL); and whether NaN stands where the plain version's NaN
    stands, and nowhere else."""
    ref = ln.layer_norm_bwd_plain(x.float(), g.float(), dy.float(), eps)
    xf, dyf = x.float(), dy.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) - mean * mean + eps)
    # x^'s own error: mean and rstd are fp32 sums taken in another order,
    # so x - mean carries an error of order |mean| * 2^-24
    xh_mag = ((xf - mean).abs() + mean.abs()) * rstd
    terms = ((dyf.abs() * xh_mag).sum(0), dyf.abs().sum(0))
    nan_ok = all(torch.equal(a.isnan(), r.isnan()) for a, r in zip(got, ref))
    keep = [~r.isnan() for r in ref]
    a, r = got[0][keep[0]], ref[0][keep[0]]
    ratio = (max_err(a, r) / bwd_tol(x.dtype, r)) if r.numel() else 0.0
    rtol = LN_BWD_RTOL[g.dtype]
    for a, r, t, k in zip(got[1:], ref[1:], terms, keep[1:]):
        if k.any():
            ratio = max(ratio, elem_ratio(a[k], r[k], rtol, t[k]))
    return ratio, nan_ok


def check_layer_norm_bwd(dev, gen, R, N, dtype, eps=1e-5):
    """The layer-norm backward kernel against its plain version (the
    composition it replaced) at the paths' shapes, run twice, bit for bit
    (ln_bwd_ratio's tolerances). Times: the kernel, the plain version and
    F.layer_norm's autograd backward (summed device-kernel time); bound:
    x and dy read and dx written once, gamma read and dgamma, dbeta
    written, some 16 fp32 operations an element on the CUDA cores."""
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    x = (1 + torch.randn(R, N, device=dev, generator=gen)).to(dtype)
    g = (1 + 0.1 * torch.randn(N, device=dev, generator=gen)).to(dtype)
    b = (0.1 * torch.randn(N, device=dev, generator=gen)).to(dtype)
    dy = torch.randn(R, N, device=dev, generator=gen).to(dtype)
    got = ln.layer_norm_bwd(x, g, dy, eps)
    again = ln.layer_norm_bwd(x, g, dy, eps)
    torch.cuda.synchronize()
    tag = "" if eps == 1e-5 else f" eps={eps:g}"
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"layer norm backward R={R} N={N}{tag} {dtype}: "
                             f"two runs differ")
    del again
    ratio, nan_ok = ln_bwd_ratio(ln, x, g, dy, eps, got)
    if not nan_ok:
        raise AssertionError(f"layer norm backward R={R} N={N}: NaN where "
                             f"the plain version has none")
    err = max(max_err(a, r) for a, r in zip(
        got, ln.layer_norm_bwd_plain(x.float(), g.float(), dy.float(), eps)))
    del got
    isz = x.element_size()
    bnd, by = bound_ms(3 * R * N * isz + 3 * N * g.element_size(),
                       16 * R * N, torch.float32)
    leaves = [t.detach().requires_grad_(True) for t in (x, g, b)]
    out = torch.nn.functional.layer_norm(leaves[0], (N,), leaves[1],
                                         leaves[2], eps)
    row = dict(
        kernel="layer_norm_bwd", dtype=str(dtype)[6:],
        shape=f"R={R} N={N}{tag}", max_abs_err=err, tol_ratio=ratio,
        ms=cuda_ms(lambda: ln.layer_norm_bwd(x, g, dy, eps)),
        plain_ms=cuda_ms(lambda: ln.layer_norm_bwd_plain(x, g, dy, eps)),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            out, leaves, dy, retain_graph=True), graph=False),
        bound_ms=bnd, bound_by=by)
    del leaves, out
    return [row]


def mode(causal):
    return "causal" if causal else "non-causal"


def attention_pairs(L, causal):
    """(q, k) pairs that attention computes at Lq == Lk == L: L^2, or
    L(L + 1)/2 at or below the causal diagonal."""
    return L * (L + 1) // 2 if causal else L * L


def check_flash(dev, gen, lengths, H, D, B=1, dtypes=(torch.float32,
                                                      torch.bfloat16),
                causal=True):
    """The flash forward against its plain version on the same inputs
    (TOL), run twice (bit for bit), timed beside SDPA, with its design's
    bound (and the CUDA-core bound of the fp32 tensor-core design)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    rows = []
    for dtype in dtypes:
        for L in lengths:
            qkv = torch.randn(B, L, 3, H, D, device=dev,
                              generator=gen).to(dtype)
            q, k, v = qkv.unbind(2)  # strided views, as the model passes them
            design = fa.fwd_design(q, k, v)
            out, lse = launched_design(
                lambda: fa.flash_attention_fwd(q, k, v, causal=causal), design)
            again = fa.flash_attention_fwd(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
                raise AssertionError(f"flash forward L={L} D={D} {dtype}: "
                                     f"two runs differ")
            ref_out, ref_lse = fa.flash_attention_plain(
                q.float(), k.float(), v.float(), causal=causal)
            err = max(max_err(out, ref_out), max_err(lse, ref_lse))
            isz = q.element_size()
            pairs = attention_pairs(L, causal)
            bounds = design_bounds(B * (4 * L * H * D * isz + 4 * H * L),
                                   B * 4 * H * D * pairs, dtype, design)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            rows.append(dict(
                kernel="flash_attention", dtype=str(dtype)[6:],
                shape=f"B={B} L={L} H={H} D={D} {mode(causal)}",
                design=design,
                max_abs_err=err, tol=TOL[dtype],
                ms=cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal)),
                plain_ms=cuda_ms(lambda: fa.flash_attention_plain(
                    q, k, v, causal)),
                library_ms=cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal)), **bounds))
    return rows


def check_paged(dev, gen, W, H, D, page_size, max_len):
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    rows = []
    pps = max_len // page_size
    num_pages = 1 + W * pps
    rng = np.random.default_rng(0)
    ctx_np = rng.integers(32, max_len + 1, W).astype(np.int32)
    ctx_np[:2] = (32, max_len)  # both ends of the range
    perm = 1 + rng.permutation(num_pages - 1)[:W * pps].reshape(W, pps)
    bt = torch.from_numpy(perm.astype(np.int32)).to(dev)
    cl = torch.from_numpy(ctx_np).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(W, H, D, device=dev, generator=gen).to(dtype)
        kp = torch.randn(num_pages, page_size, H, D, device=dev,
                         generator=gen).to(dtype)
        vp = torch.randn(num_pages, page_size, H, D, device=dev,
                         generator=gen).to(dtype)
        out = pa.paged_attention(q, kp, vp, bt, cl)
        again = pa.paged_attention(q, kp, vp, bt, cl)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"paged_attention {dtype}: two runs differ")
        err = max_err(out, pa.paged_attention_plain(q.float(), kp.float(),
                                                    vp.float(), bt, cl))
        isz = q.element_size()
        tokens = int(ctx_np.sum())
        live_pages = int(sum(-(-c // page_size) for c in ctx_np))
        nbytes = (2 * tokens * H * D * isz + 2 * W * H * D * isz
                  + 4 * live_pages + 4 * W)
        bnd, by = bound_ms(nbytes, 4 * H * D * tokens, dtype)
        rows.append(dict(
            kernel="paged_attention", dtype=str(dtype)[6:],
            shape=(f"W={W} H={H} D={D} page={page_size} "
                   f"ctx={int(ctx_np.min())}-{int(ctx_np.max())}"),
            design=pa.kernel_design(kp, vp, bt),
            max_abs_err=err, tol=TOL[dtype],
            ms=cuda_ms(lambda: pa.paged_attention(q, kp, vp, bt, cl)),
            plain_ms=cuda_ms(lambda: pa.paged_attention_plain(
                q, kp, vp, bt, cl)),
            library_ms=None, bound_ms=bnd, bound_by=by))
    return rows


def bwd_tol(dtype, ref):
    """Tolerance of a backward output against its fp32 plain version on
    the same inputs: fp32 1e-4 and bf16 2e-2 (one bf16 rounding) of the
    output's own scale, max(1, max |ref|); gradients grow with L and the
    flash kernel's dq is summed with atomics in a varying order."""
    return TOL[dtype] * max(1.0, float(ref.abs().max()))


def check_flash_bwd(dev, gen, lengths, B, H, D,
                    dtypes=(torch.float32, torch.bfloat16), causal=True):
    """The one-pass backward (the GPT step's, below the 6 MiB gate) against
    its plain version on the same inputs (bwd_tol), run twice: dk and dv
    must repeat bit for bit, dq (summed with atomics in a varying order)
    within bwd_tol of the first run; the design its C entry reports must
    be `bwd_design`'s. Times: the backward as the model calls it (delta,
    the zeroed fp32 dq, the kernel and dq's cast), its plain version,
    SDPA's backward (summed device-kernel time) and, as `split_ms`, delta
    and the split pair (dq then dk/dv) on the same inputs in the same
    call: the other route past the gate. Bounds at the design's peak (and
    the CUDA-core one beside a 3xTF32 row's, `design_bounds`)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    rows = []
    for dtype in dtypes:
        for L in lengths:
            qkv = torch.randn(B, L, 3, H, D, device=dev,
                              generator=gen).to(dtype)
            q, k, v = qkv.unbind(2)
            out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            do = torch.randn(B, L, H, D, device=dev, generator=gen).to(dtype)
            design = fa.bwd_design(q, k, v, do)
            got = launched_design(lambda: fa.flash_attention_bwd(
                q, k, v, out, lse, do, causal), design,
                ("flash_attention_bwd",))
            again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
            torch.cuda.synchronize()
            if not (torch.equal(got[1], again[1])
                    and torch.equal(got[2], again[2])):
                raise AssertionError(f"one-pass backward B={B} L={L} D={D} "
                                     f"{dtype}: dk or dv differ between two "
                                     f"runs")
            repeat = max_err(got[0], again[0]) / bwd_tol(dtype, got[0])
            del again
            delta = fa.attention_delta(out, do)
            ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                               lse, delta, do.float(), causal)
            ratio = max(max_err(g, r) / bwd_tol(dtype, r)
                        for g, r in zip(got, ref))
            err = max(max_err(g, r) for g, r in zip(got, ref))
            del ref
            isz = q.element_size()
            pairs = attention_pairs(L, causal)
            # reads q, k, v, out, do and lse; writes dq, dk, dv; five
            # products of 2*D operations per (q, k) pair
            bounds = design_bounds(B * H * (8 * L * D * isz + 4 * L),
                                   B * H * 10 * D * pairs, dtype, design)
            leaves = [t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v)]
            ref_out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, is_causal=causal)
            do_t = do.transpose(1, 2)
            rows.append(dict(
                kernel="flash_attention_bwd", dtype=str(dtype)[6:],
                shape=f"B={B} L={L} H={H} D={D} {mode(causal)}",
                design=design,
                max_abs_err=err, tol_ratio=ratio,
                witnesses={"dq of a second run": repeat},
                ms=cuda_ms(lambda: fa.flash_attention_bwd(
                    q, k, v, out, lse, do, causal), iters=5, reps=3),
                split_ms=cuda_ms(lambda: _split_bwd(
                    fa, q, k, v, lse, fa.attention_delta(out, do), do,
                    causal), iters=5, reps=3),
                plain_ms=cuda_ms(lambda: fa.flash_attention_bwd_plain(
                    q, k, v, lse, fa.attention_delta(out, do), do, causal),
                    iters=5, reps=3),
                library_ms=cuda_ms(lambda: torch.autograd.grad(
                    ref_out, leaves, do_t, retain_graph=True),
                    iters=5, reps=3, graph=False), **bounds))
            del got, leaves, ref_out
    return rows


#: the long-context path's attention: GPT-2 small's heads at 32,768 tokens
LONG_L, LONG_H, LONG_D = 32768, 12, 64


def plain_by_head(f, *args, causal=True):
    """f(*args, causal) run on one head at a time, every [B, L, H, D]
    argument and [B, H, L] one cut to head h, and the outputs joined again
    along the head axis. At L 32,768 one head's fp32 [L, L] scores take
    4.3 GB and a plain backward holds four such tensors at once (about
    18 GB); all twelve heads at once would need twelve times that."""
    def cut(t, h):
        return t[:, :, h:h + 1] if t.dim() == 4 else t[:, h:h + 1]
    outs = [f(*(cut(t, h) for t in args), causal)
            for h in range(args[0].shape[2])]
    if isinstance(outs[0], torch.Tensor):
        outs = [(o,) for o in outs]
    joined = tuple(torch.cat(parts, dim=2 if parts[0].dim() == 4 else 1)
                   for parts in zip(*outs))
    return joined if len(joined) > 1 else joined[0]


def event_ms(fn, reps=2):
    """Mean time of fn() between two CUDA events, after one warm-up call:
    for calls of tens of milliseconds or more, whose launch cost on the
    host is small beside their device time and which allocate too much to
    capture in a graph."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _split_bwd(fa, q, k, v, lse, delta, do, causal, mask=None):
    return (fa.flash_attention_bwd_dq(q, k, v, lse, delta, do, causal,
                                      mask=mask),
            *fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal,
                                        mask=mask))


def _split_plain(fa, q, k, v, lse, delta, do, causal):
    """The split pair's plain versions on fp32 copies of the inputs, one
    head at a time."""
    args = [t.float() for t in (q, k, v)] + [lse, delta, do.float()]
    return (plain_by_head(fa.flash_attention_bwd_dq_plain, *args,
                          causal=causal),
            *plain_by_head(fa.flash_attention_bwd_dkv_plain, *args,
                           causal=causal))


def _attention_inputs(dev, gen, B, Lq, Lk, H, D, dtype):
    """q, k, v as strided views of one qkv tensor when Lq == Lk (as the
    model passes them) and dO."""
    if Lq == Lk:
        q, k, v = torch.randn(B, Lq, 3, H, D, device=dev,
                              generator=gen).to(dtype).unbind(2)
    else:
        q = torch.randn(B, Lq, H, D, device=dev, generator=gen).to(dtype)
        k, v = torch.randn(B, Lk, 2, H, D, device=dev,
                           generator=gen).to(dtype).unbind(2)
    do = torch.randn(B, Lq, H, D, device=dev, generator=gen).to(dtype)
    return q, k, v, do


def split_bwd_bounds(B, L, H, D, isz):
    """(dq, dk/dv) bound rows' (bytes, FLOPs) at causal length L: each reads
    q, k, v, dO, lse and delta once and writes its outputs once; per causal
    (q, k) pair the dq walk does three products of 2 * D operations (S, dP,
    dS K), the dk/dv walk four (S, dP, P^T dO, dS^T Q): seven in all,
    7 * B * H * L^2 * D operations."""
    pairs = L * (L + 1) // 2
    read = B * H * (4 * L * D * isz + 8 * L)
    return ((read + B * H * L * D * isz, B * H * 6 * D * pairs),
            (read + 2 * B * H * L * D * isz, B * H * 8 * D * pairs))


def fp64_tile_ratio(q, k, v, lse, delta, do, got, T=64):
    """Worst error / bwd_tol of the split pair's causal (dq, dk, dv) = got
    against an fp64 computation from the same inputs (lse and delta
    included), on the first, middle and last T-row q tiles (dq) and T-key
    k tiles (dk, dv) of the first and last heads: a witness with another
    summation order, since cuBLAS may add the fp32 plain version's products
    in the kernels' own order (B 1)."""
    L, H, D = q.shape[1], q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(D)
    pos = torch.arange(L, device=q.device)
    worst = 0.0
    for h in (0, H - 1):
        qh, kh, vh, doh = (t[0, :, h].double() for t in (q, k, v, do))
        lh, dh = lse[0, h].double(), delta[0, h].double()
        for t0 in (0, L // 2, L - T):
            r = slice(t0, t0 + T)
            p = torch.exp(qh[r] @ kh.T * scale - lh[r, None]).masked_fill(
                pos[None, :] > pos[r, None], 0.0)
            ds = p * (doh[r] @ vh.T - dh[r, None])
            pairs = [(got[0][0, r, h], ds @ kh * scale)]
            p = torch.exp(qh @ kh[r].T * scale - lh[:, None]).masked_fill(
                pos[r][None, :] > pos[:, None], 0.0)
            ds = p * (doh @ vh[r].T - dh[:, None])
            pairs += [(got[1][0, r, h], ds.T @ qh * scale),
                      (got[2][0, r, h], p.T @ doh)]
            worst = max(worst, *(max_err(g, w) / bwd_tol(g.dtype, w)
                                 for g, w in pairs))
    return worst


def check_flash_bwd_split(dev, gen):
    """The split backward's dq and dk/dv kernels (called directly: the
    model's gate sends them only L past 24,576 at D = 64).

    Timed rows, causal: at B 1, H 12, D 64, L 4,096 and the long path's
    L 32,768 in fp32 and bf16; in bf16 also L 1,000 (not a multiple of the
    64-row tile) and D 128 at H 16, L 4,096 (the GPT-3 presets' head dim,
    the other tensor-core instance). Each is held against the plain
    versions on the same inputs (bwd_tol), run one head at a time
    (plain_by_head), and timed so. At L 32,768 two more witnesses: fp64
    tiles (fp64_tile_ratio), and the one-pass kernel on the same inputs,
    dq to bwd_tol (its atomic order); dk and dv closer, to 1e-6 of scale,
    since both kernels run the same walk for them (`kv_walk` in fp32,
    `kv_walk_tc` in bf16), the one-pass kernel adding only its dq
    product. Library: SDPA's backward (all
    three gradients) at the same shape, summed device-kernel time. Each
    pair also runs twice and must repeat bit for bit (no atomics)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    rows = []
    cases = [(torch.float32, 4096, LONG_H, LONG_D),
             (torch.float32, LONG_L, LONG_H, LONG_D),
             (torch.bfloat16, 1000, LONG_H, LONG_D),
             (torch.bfloat16, 4096, LONG_H, LONG_D),
             (torch.bfloat16, 4096, 16, 128),
             (torch.bfloat16, LONG_L, LONG_H, LONG_D)]
    for dtype, L, H, D in cases:
        B = 1
        q, k, v, do = _attention_inputs(dev, gen, B, L, L, H, D, dtype)
        design = fa.bwd_design(q, k, v, do)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        delta = fa.attention_delta(out, do)
        got = launched_design(lambda: _split_bwd(
            fa, q, k, v, lse, delta, do, True), design, SPLIT)
        again = _split_bwd(fa, q, k, v, lse, delta, do, True)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"split backward L={L} {dtype}: two "
                                 f"runs differ")
        del again
        ref = _split_plain(fa, q, k, v, lse, delta, do, True)
        ratios = [max_err(g, r) / bwd_tol(dtype, r)
                  for g, r in zip(got, ref)]
        errs = [max_err(g, r) for g, r in zip(got, ref)]
        del ref
        long = L == LONG_L
        witness = [{}, {}]
        if long:
            one = fa.flash_attention_bwd_fused(q, k, v, lse, delta, do,
                                               True)
            w = [max_err(got[0], one[0]) / bwd_tol(dtype, one[0])]
            w += [max_err(g, r) / (1e-6 * max(1.0, float(r.abs().max())))
                  for g, r in zip(got[1:], one[1:])]
            del one
            f64 = fp64_tile_ratio(q, k, v, lse, delta, do, got)
            witness = [{"one-pass kernel": w[0], "fp64 tiles": f64},
                       {"one-pass kernel": max(w[1:]),
                        "fp64 tiles": f64}]
        del got
        isz = q.element_size()
        (qb, qf), (kb, kf) = split_bwd_bounds(B, L, H, D, isz)
        n = (1, 3) if long else (5, 3)
        ms_dq = cuda_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, lse, delta, do, True), iters=n[0], reps=n[1],
            warmup=1)
        ms_dkv = cuda_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, lse, delta, do, True), iters=n[0], reps=n[1],
            warmup=1)
        fused_ms = (cuda_ms(lambda: fa.flash_attention_bwd_fused(
            q, k, v, lse, delta, do, True), iters=n[0], reps=n[1],
            warmup=1) if long else None)
        leaves = [t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v)]
        lib_ms = sdpa_bwd_ms(leaves, do.transpose(1, 2), n[1])
        del leaves
        torch.cuda.empty_cache()
        plain = [event_ms(lambda: plain_by_head(
            f, q, k, v, lse, delta, do), reps=1)
            for f in (fa.flash_attention_bwd_dq_plain,
                      fa.flash_attention_bwd_dkv_plain)]
        shape = f"B={B} L={L} H={H} D={D} causal"
        for name, err, ratio, wit, ms, pms, (nb, fl) in (
                ("flash_attention_bwd_dq", errs[0], ratios[0],
                 witness[0], ms_dq, plain[0], (qb, qf)),
                ("flash_attention_bwd_dkv", max(errs[1:]),
                 max(ratios[1:]), witness[1], ms_dkv, plain[1],
                 (kb, kf))):
            rows.append(dict(
                kernel=name, dtype=str(dtype)[6:], shape=shape,
                design=design, max_abs_err=err, tol_ratio=ratio, ms=ms,
                plain_ms=pms,
                plain_shape=f"L={L}, one head at a time",
                library_ms=lib_ms, one_pass_ms=fused_ms, witnesses=wit,
                **design_bounds(nb, fl, dtype, design)))
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return rows


def check_flash_long(dev, gen):
    """The flash forward at the long path's B 1, L 32,768, H 12, D 64,
    causal, held against its plain version on the same inputs (TOL), run
    and timed one head at a time (plain_by_head); SDPA's output on the
    same inputs is a second witness (TOL: the same function, summed in
    another order), and SDPA's forward the library time."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _ = _attention_inputs(dev, gen, 1, LONG_L, LONG_L, LONG_H,
                                       LONG_D, dtype)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        design = fa.fwd_design(q, k, v)
        out, lse = launched_design(
            lambda: fa.flash_attention_fwd(q, k, v, causal=True), design)
        ref_out, ref_lse = plain_by_head(fa.flash_attention_plain,
                                         q.float(), k.float(), v.float())
        err = max(max_err(out, ref_out), max_err(lse, ref_lse))
        del ref_out, ref_lse
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            wit = sdpa(qt, kt, vt, is_causal=True).transpose(1, 2)
            lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True),
                             iters=1, reps=3, warmup=1)
        wit_err = max_err(out, wit)
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, True), iters=1,
                     reps=3, warmup=1)
        del out, lse, wit
        torch.cuda.empty_cache()
        plain_ms = event_ms(lambda: plain_by_head(fa.flash_attention_plain,
                                                  q, k, v), reps=1)
        isz = q.element_size()
        pairs = LONG_L * (LONG_L + 1) // 2
        bounds = design_bounds(4 * LONG_L * LONG_H * LONG_D * isz
                               + 4 * LONG_H * LONG_L,
                               4 * LONG_H * LONG_D * pairs, dtype, design)
        rows.append(dict(
            kernel="flash_attention", dtype=str(dtype)[6:],
            shape=f"B=1 L={LONG_L} H={LONG_H} D={LONG_D} causal",
            design=design, max_abs_err=err, tol=TOL[dtype], ms=ms,
            plain_ms=plain_ms,
            plain_shape=f"L={LONG_L}, one head at a time",
            library_ms=lib_ms, one_pass_ms=None,
            witnesses={"SDPA": wit_err / TOL[dtype]}, **bounds))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def sdpa_bwd_ms(leaves, do_t, reps):
    """SDPA's causal backward on [B, H, L, D] leaves, summed device-kernel
    time, through its flash or memory-efficient backend: the math
    backend's fp32 scores do not fit at L 32,768."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=True)
    return cuda_ms(lambda: torch.autograd.grad(
        out, leaves, do_t, retain_graph=True), iters=1, reps=reps,
        graph=False)


def check_split_edges(dev, gen):
    """Correctness only: the split pair against its plain versions at
    L 1, 63, 100, 1,024 and 4,096, causal and not, D 64 and 128, fp32 and
    bf16, and at Lk != Lq (causal with the kv offset). Returns {kernel:
    worst error / tolerance}."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    worst = {"flash_attention_bwd_dq": 0.0, "flash_attention_bwd_dkv": 0.0}
    cases = [(L, L, c, D) for L in (1, 63, 100, 1024, 4096)
             for c in (True, False) for D in (64, 128)]
    cases += [(37, 130, True, 64), (100, 70, False, 64)]
    for dtype in (torch.float32, torch.bfloat16):
        for Lq, Lk, causal, D in cases:
            q, k, v, do = _attention_inputs(dev, gen, 1, Lq, Lk, 3, D, dtype)
            out, lse = fa.flash_attention_fwd(q, k, v, causal)
            delta = fa.attention_delta(out, do)
            got = _split_bwd(fa, q, k, v, lse, delta, do, causal)
            ref = _split_plain(fa, q, k, v, lse, delta, do, causal)
            r = [max_err(g, w) / bwd_tol(dtype, w) for g, w in zip(got, ref)]
            worst["flash_attention_bwd_dq"] = max(
                worst["flash_attention_bwd_dq"], r[0])
            worst["flash_attention_bwd_dkv"] = max(
                worst["flash_attention_bwd_dkv"], *r[1:])
    torch.cuda.synchronize()
    return worst


# --------------------- phase 3: the flash kernels' bool mask ---------------

#: phase 21's attention: nn.Transformer at its defaults (8 heads of 64) at
#: B 32, sources padded to 128 and targets to 112
TB_B, TB_LS, TB_LT, TB_H, TB_D = 32, 128, 112, 8, 64
#: the masked kernels' counters, by the unmasked kernel's name
MASKED = {"flash_attention": "flash_attention_masked",
          "flash_attention_bwd": "flash_attention_bwd_masked",
          "flash_attention_bwd_dq": "flash_attention_bwd_dq_masked",
          "flash_attention_bwd_dkv": "flash_attention_bwd_dkv_masked"}


def padding_masks(src_len, tgt_len, Ls, Lt):
    """(src_mask [B, 1, 1, Ls], tgt_mask [B, 1, Lt, Lt], memory_mask
    [B, 1, 1, Ls]), bool, True = attend, for rows of `src_len` and
    `tgt_len` real tokens (int64 [B] tensors): real keys only, and in the
    target the lower triangle too."""
    dev = src_len.device
    src = torch.arange(Ls, device=dev) < src_len[:, None]
    tgt = torch.arange(Lt, device=dev) < tgt_len[:, None]
    tril = torch.ones(Lt, Lt, dtype=torch.bool, device=dev).tril()
    return (src[:, None, None, :], tril & tgt[:, None, None, :],
            src[:, None, None, :])


def make_mask(dev, gen, kind, B, H, Lq, Lk):
    """A bool mask of `kind`: "pad" [B, 1, 1, Lk] (lengths Lk/2..Lk),
    "tril_pad" [B, 1, Lq, Lk] (the same and the lower triangle), "random"
    [B, H, Lq, Lk] (30 % masked, and every fourth row of head 0 masked
    whole) or "shared" [1, 1, Lq, Lk] (random, row 0 masked whole)."""
    if kind in ("pad", "tril_pad"):
        lens = torch.randint(Lk // 2, Lk + 1, (B,), device=dev, generator=gen)
        m = torch.arange(Lk, device=dev) < lens[:, None]
        m = m[:, None, None, :]
        if kind == "tril_pad":
            m = m & torch.ones(Lq, Lk, dtype=torch.bool, device=dev).tril(
                diagonal=Lk - Lq)
        return m
    shape = (B, H, Lq, Lk) if kind == "random" else (1, 1, Lq, Lk)
    m = torch.rand(shape, device=dev, generator=gen) > 0.3
    if kind == "random":
        m[:, 0, ::4] = False
    else:
        m[:, :, 0] = False
    return m


def empty_rows(mask, causal, B, H, Lq, Lk):
    """[B, Lq, H] bool: the query rows that see no key."""
    keep = mask.expand(B, H, Lq, Lk)
    if causal:
        keep = keep & torch.ones(Lq, Lk, dtype=torch.bool,
                                 device=mask.device).tril(diagonal=Lk - Lq)
    return (~keep.any(dim=-1)).transpose(1, 2)


def masked_ratios(fa, q, k, v, do, mask, causal, design):
    """The four masked kernels on one input against their plain versions
    on fp32 copies: {kernel: (max abs error, worst error / tolerance)}
    (TOL forward, bwd_tol backward; lse on the rows that see a key, -inf
    on the others in both), after checking that a row with no visible
    key gives exactly 0 in out and dq (one-pass and split), that nothing
    is NaN, that the forward reports `design` and the backwards
    `bwd_design`'s, that the forward repeats bit for bit, and that the
    split pair repeats bit for bit."""
    B, Lq, H, _ = q.shape
    Lk = k.shape[1]
    dtype = q.dtype
    bwd = fa.bwd_design(q, k, v, do)
    out, lse = launched_design(
        lambda: fa.flash_attention_fwd(q, k, v, causal, mask=mask), design,
        (MASKED["flash_attention"],))
    again = fa.flash_attention_fwd(q, k, v, causal, mask=mask)
    f32 = [t.float() for t in (q, k, v)]
    ref_out, ref_lse = fa.flash_attention_plain(*f32, causal, mask=mask)
    delta = fa.attention_delta(out, do)
    one = launched_design(lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, do, causal, mask=mask), bwd,
        (MASKED["flash_attention_bwd"],))
    split = launched_design(lambda: _split_bwd(
        fa, q, k, v, lse, delta, do, causal, mask), bwd,
        tuple(MASKED[n] for n in SPLIT))
    split2 = _split_bwd(fa, q, k, v, lse, delta, do, causal, mask)
    ref = fa.flash_attention_bwd_plain(*f32, lse, delta, do.float(), causal,
                                       mask=mask)
    torch.cuda.synchronize()
    empty = empty_rows(mask, causal, B, H, Lq, Lk)
    seen = ~empty.transpose(1, 2)
    where = f"B={B} Lq={Lq} Lk={Lk} H={H} D={q.shape[-1]} {dtype} {design}"
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        raise AssertionError(f"masked forward {where}: two runs differ")
    if not all(torch.equal(a, b) for a, b in zip(split, split2)):
        raise AssertionError(f"masked split pair {where}: two runs differ")
    if not torch.equal(torch.isinf(lse), ~seen) or not torch.equal(
            torch.isinf(ref_lse), ~seen):
        raise AssertionError(f"masked forward {where}: lse is not -inf "
                             f"exactly on the rows that see no key")
    for name, t in (("out", out), ("one-pass dq", one[0]),
                    ("split dq", split[0])):
        if bool(empty.any()) and bool(t[empty].abs().max() != 0):
            raise AssertionError(f"masked {name} {where}: a row with no "
                                 f"visible key is not exactly 0")
    if any(bool(torch.isnan(t).any()) for t in (out, *one, *split)):
        raise AssertionError(f"masked kernels {where}: NaN")
    fwd = max(max_err(out, ref_out), max_err(lse[seen], ref_lse[seen]))

    def worst(got, want):
        return (max(max_err(g, r) for g, r in zip(got, want)),
                max(max_err(g, r) / bwd_tol(dtype, r)
                    for g, r in zip(got, want)))

    return {"flash_attention_masked": (fwd, fwd / TOL[dtype]),
            "flash_attention_bwd_masked": worst(one, ref),
            "flash_attention_bwd_dq_masked": worst(split[:1], ref[:1]),
            "flash_attention_bwd_dkv_masked": worst(split[1:], ref[1:])}


def masked_bounds(q, k, mask, isz):
    """((bytes, FLOPs) forward, (bytes, FLOPs) one-pass backward) of
    masked, non-causal attention: the mask's own bytes (never expanded)
    beside the tensors', and the operations of all Lq * Lk (q, k) pairs,
    which the kernels walk: the masked pairs are computed and then
    dropped."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    pairs = Lq * Lk
    mb = mask.numel()
    fwd = (B * H * ((2 * Lq + 2 * Lk) * D * isz + 4 * Lq) + mb,
           B * H * 4 * D * pairs)
    bwd = (B * H * ((4 * Lq + 4 * Lk) * D * isz + 8 * Lq) + mb,
           B * H * 10 * D * pairs)
    return fwd, bwd


def check_flash_masked(dev, gen):
    """Timed rows of the masked forward and one-pass backward at phase
    21's shapes (B 32, H 8, D 64): the encoder's self-attention (L 128,
    [B, 1, 1, L] key padding), the decoder's (L 112, tril-and-padding
    [B, 1, L, L]) and cross-attention (Lq 112, Lk 128, [B, 1, 1, Lk]), in
    bf16 (the O2 step's) and fp32 (its cross-check's), each held to its
    plain version by `masked_ratios` (which runs the split pair too: its
    worst error / tolerance is returned beside the rows) and timed beside
    its plain version and SDPA's call (forward, and backward by summed
    device-kernel time) with the same bool mask."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    rows = []
    split = {MASKED["flash_attention_bwd_dq"]: 0.0,
             MASKED["flash_attention_bwd_dkv"]: 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for Lq, Lk, kind in ((TB_LS, TB_LS, "pad"),
                             (TB_LT, TB_LT, "tril_pad"),
                             (TB_LT, TB_LS, "pad")):
            B, H, D = TB_B, TB_H, TB_D
            q, k, v, do = _attention_inputs(dev, gen, B, Lq, Lk, H, D, dtype)
            mask = make_mask(dev, gen, kind, B, H, Lq, Lk)
            design = fa.fwd_design(q, k, v)
            r = masked_ratios(fa, q, k, v, do, mask, False, design)
            for name in split:
                split[name] = max(split[name], r[name][1])
            out, lse = fa.flash_attention_fwd(q, k, v, False, mask=mask)
            (fb, ff), (bb, bf) = masked_bounds(q, k, mask, q.element_size())
            leaves = [t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v)]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            ref_out = sdpa(*leaves, attn_mask=mask)
            do_t = do.transpose(1, 2)
            shape = f"B={B} Lq={Lq} Lk={Lk} H={H} D={D} {kind}"
            common = dict(dtype=str(dtype)[6:], shape=shape, mask=list(
                mask.shape), witnesses={})
            rows.append(dict(
                kernel="flash_attention_masked", design=design,
                max_abs_err=r["flash_attention_masked"][0],
                tol_ratio=r["flash_attention_masked"][1],
                ms=cuda_ms(lambda: fa.flash_attention_fwd(
                    q, k, v, False, mask=mask)),
                plain_ms=cuda_ms(lambda: fa.flash_attention_plain(
                    q, k, v, False, mask=mask)),
                library_ms=cuda_ms(lambda: sdpa(
                    *(t.detach() for t in leaves), attn_mask=mask)),
                **design_bounds(fb, ff, dtype, design), **common))
            bwd = fa.bwd_design(q, k, v, do)
            rows.append(dict(
                kernel="flash_attention_bwd_masked", design=bwd,
                max_abs_err=r["flash_attention_bwd_masked"][0],
                tol_ratio=r["flash_attention_bwd_masked"][1],
                ms=cuda_ms(lambda: fa.flash_attention_bwd(
                    q, k, v, out, lse, do, False, mask=mask), iters=5,
                    reps=3),
                plain_ms=cuda_ms(lambda: fa.flash_attention_bwd_plain(
                    q, k, v, lse, fa.attention_delta(out, do), do, False,
                    mask=mask), iters=5, reps=3),
                library_ms=cuda_ms(lambda: torch.autograd.grad(
                    ref_out, leaves, do_t, retain_graph=True), iters=5,
                    reps=3, graph=False),
                **design_bounds(bb, bf, dtype, bwd), **common))
            del leaves, ref_out
    return rows, split


def check_masked_edges(dev, gen):
    """Correctness only: the four masked kernels (`masked_ratios`) in
    every design: bf16 and fp32 at D 64 and 128 (tensor cores; fp32 also
    at Lq <= 32, its 2-warp block), D 80 (CUDA cores); random
    [B, H, Lq, Lk] masks with whole rows masked, a shared [1, 1, Lq, Lk]
    one, key padding and tril-and-padding; Lq != Lk, tails off the
    64-row tile (100, 112, 130), and the mask with causal (the interior
    tiles of the causal walk need the mask too). Returns {kernel: worst
    error / tolerance}."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    worst = dict.fromkeys(MASKED.values(), 0.0)
    cases = [(2, 4, 100, 130, 64, "random", False),
             (2, 4, 112, 112, 64, "random", True),
             (2, 4, 100, 130, 64, "shared", True),
             (2, 4, 130, 100, 128, "random", False),
             (2, 4, 200, 200, 128, "tril_pad", True),
             (2, 4, 100, 130, 80, "random", True),
             (2, 4, 64, 64, 80, "pad", False),
             (3, 2, 20, 20, 64, "random", True),
             (3, 2, 20, 45, 64, "pad", False)]
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, Lq, Lk, D, kind, causal in cases:
            q, k, v, do = _attention_inputs(dev, gen, B, Lq, Lk, H, D, dtype)
            mask = make_mask(dev, gen, kind, B, H, Lq, Lk)
            r = masked_ratios(fa, q, k, v, do, mask, causal,
                              fa.fwd_design(q, k, v))
            for name, (_, x) in r.items():
                worst[name] = max(worst[name], x)
    return worst


def check_split_masked(dev, gen):
    """The split pair with the mask at the long path's B 1, L 32,768,
    H 12, D 64, bf16, non-causal, the last 2,768 keys padded away by a
    [1, 1, 1, L] mask: against its plain versions one head at a time
    (bwd_tol; every row sees a key), run twice, bit for bit, and timed
    beside SDPA's backward with the same mask where its memory-efficient
    backend takes it (else None). Returns the dq and dk/dv rows."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    B, L, H, D, pad = 1, LONG_L, LONG_H, LONG_D, 2768
    dtype = torch.bfloat16
    q, k, v, do = _attention_inputs(dev, gen, B, L, L, H, D, dtype)
    mask = (torch.arange(L, device=dev) < L - pad)[None, None, None, :]
    out, lse = fa.flash_attention_fwd(q, k, v, False, mask=mask)
    delta = fa.attention_delta(out, do)
    got = _split_bwd(fa, q, k, v, lse, delta, do, False, mask)
    again = _split_bwd(fa, q, k, v, lse, delta, do, False, mask)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("masked split pair L 32,768: two runs differ")
    del again
    args = [t.float() for t in (q, k, v)] + [lse, delta, do.float()]
    plains = [functools.partial(f, mask=mask) for f in (
        fa.flash_attention_bwd_dq_plain, fa.flash_attention_bwd_dkv_plain)]
    ref = (plain_by_head(plains[0], *args, causal=False),
           *plain_by_head(plains[1], *args, causal=False))
    ratios = [max_err(g, r) / bwd_tol(dtype, r) for g, r in zip(got, ref)]
    errs = [max_err(g, r) for g, r in zip(got, ref)]
    del got, ref, args
    torch.cuda.empty_cache()
    ms = [cuda_ms(lambda: f(q, k, v, lse, delta, do, False, mask=mask),
                  iters=1, reps=3, warmup=1)
          for f in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)]
    plain_ms = [event_ms(lambda: plain_by_head(f, q, k, v, lse, delta, do,
                                               causal=False), reps=1)
                for f in plains]
    leaves = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
    try:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            lib_out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=mask)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            lib_out, leaves, do.transpose(1, 2), retain_graph=True),
            iters=1, reps=3, graph=False)
        del lib_out
    except RuntimeError as e:  # the library call only: no kernel's route
        log(f"split masked: SDPA's backward with the mask not timed: {e}")
        lib_ms = None
    del leaves
    torch.cuda.empty_cache()
    isz = q.element_size()
    read = B * H * (4 * L * D * isz + 8 * L) + mask.numel()
    pairs = L * L
    rows = []
    for name, nbytes, flops, err, ratio, t, pt in (
            ("flash_attention_bwd_dq_masked", read + B * H * L * D * isz,
             B * H * 6 * D * pairs, errs[0], ratios[0], ms[0], plain_ms[0]),
            ("flash_attention_bwd_dkv_masked",
             read + 2 * B * H * L * D * isz, B * H * 8 * D * pairs,
             max(errs[1:]), max(ratios[1:]), ms[1], plain_ms[1])):
        bnd, by = bound_ms(nbytes, flops, dtype)
        rows.append(dict(
            kernel=name, dtype="bfloat16",
            shape=f"B=1 Lq={L} Lk={L} H={H} D={D} pad {pad}",
            mask=list(mask.shape), design=fa.bwd_design(q, k, v, do),
            max_abs_err=err, tol_ratio=ratio, ms=t, plain_ms=pt,
            plain_shape=f"L={L}, one head at a time", library_ms=lib_ms,
            bound_ms=bnd, bound_by=by))
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()
    return rows


#: softmax CE dlogits, per element relative to the element's own size
#: (nearly every dlogit is about |dnll| / V, far below the label column's
#: |dnll|): fp32 1e-5 (expf and the product a few ulp from torch's); bf16
#: that plus 2^-8, the unit roundoff of bf16's 8-bit significand, since
#: the kernel rounds its fp32 value to bf16 once (a right kernel reads
#: close to 1 / (1 + 2^-8) of 2^-8 somewhere in 412M elements)
CE_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8 + 1e-5}


def rel_ratio(got, ref, rtol):
    """Worst |got - ref| / (rtol * |ref|) over the elements, so that a
    small term wrong by more than rtol fails however large the row's other
    terms are; a floor of 1e-30 lets two values that both underflow
    agree."""
    got, ref = got.float(), ref.float()
    return float(((got - ref).abs() / (rtol * ref.abs() + 1e-30)).max())


def ce_fwd_ratio(nll, lse, rnll, rlse):
    """Worst error of nll and lse against the plain ones, each row held to
    1e-5 of its own max(|lse|, 1): lse is a sum of V terms taken in
    another order, and nll = lse - logit keeps lse's absolute error."""
    scale = 1e-5 * rlse.abs().clamp(min=1.0)
    err = torch.maximum((nll - rnll).abs(), (lse - rlse).abs())
    return float((err / scale).max())


def _ce_inputs(dev, gen, N, V, dtype):
    """Logits, labels with some at -100 (ignore_index) and some at V, and
    dnll; the same labels with the out-of-range ones at -100 for
    torch.nn.functional.cross_entropy, which faults on V."""
    x = (2 * torch.randn(N, V, device=dev, generator=gen)).to(dtype)
    lab = torch.randint(0, V, (N,), device=dev, generator=gen,
                        dtype=torch.int32)
    lab[::17] = -100
    lab[5::23] = V
    dnll = torch.randn(N, device=dev, generator=gen)
    lib_lab = torch.where((lab >= 0) & (lab < V), lab, -100).long()
    return x, lab, dnll, lib_lab


def ce_pair(sce, x, lab, dnll):
    """The CE kernels on (x, lab, dnll): (nll, lse, dlogits), each
    launch's design held to the wrapper's prediction (``fwd_design``,
    ``bwd_design``) and the pair run twice, bit for bit, NaN included."""
    N, V = x.shape
    nll, lse = launched_design(lambda: sce.softmax_ce_fwd(x, lab),
                               sce.fwd_design(V),
                               ("softmax_ce_fwd",))
    dl = launched_design(lambda: sce.softmax_ce_bwd(x, lab, lse, dnll),
                         sce.bwd_design(V), ("softmax_ce_bwd",))
    nll2, lse2 = sce.softmax_ce_fwd(x, lab)
    if not (same_bits(nll, nll2) and same_bits(lse, lse2)
            and same_bits(dl, sce.softmax_ce_bwd(x, lab, lse, dnll))):
        raise AssertionError(f"softmax_ce N={N} V={V} {x.dtype}: two runs "
                             f"differ")
    return nll, lse, dl


def check_ce(dev, gen, N, V, iters=5, dtypes=(torch.float32,
                                              torch.bfloat16)):
    """Both CE kernels against their plain versions, each launch's design
    held to the prediction and run twice, bit for bit (``ce_pair``);
    `iters` calls in each timed graph (fewer at the long path's N 32,768,
    where one fp32 plain call holds some 30 GB; at most 10 MB of logits,
    20 calls in 5 replays, as the launch floor is timed, so the graph's
    own launch does not weigh on a few-microsecond kernel)."""
    n = (20, 5) if N * V * 4 <= 1e7 else (iters, 3)
    from paddle_tpu_torch.ops.kernels import softmax_ce as sce
    F = torch.nn.functional
    rows = []
    for dtype in dtypes:
        x, lab, dnll, lib_lab = _ce_inputs(dev, gen, N, V, dtype)
        nll, lse, dl = ce_pair(sce, x, lab, dnll)
        torch.cuda.synchronize()
        rnll, rlse = sce.softmax_ce_fwd_plain(x.float(), lab)
        fwd_err = max(max_err(nll, rnll), max_err(lse, rlse))
        fwd_ratio = ce_fwd_ratio(nll, lse, rnll, rlse)
        del rnll, rlse
        # the backward's inputs include lse: the plain one gets the kernel's
        rdl = sce.softmax_ce_bwd_plain(x.float(), lab, lse, dnll)
        bwd_err = max_err(dl, rdl)
        bwd_ratio = rel_ratio(dl, rdl, CE_RTOL[dtype])
        del dl, rdl
        torch.cuda.empty_cache()
        isz = x.element_size()
        fbnd, fby = bound_ms(N * V * isz + 12 * N, 3 * N * V, torch.float32)
        bbnd, bby = bound_ms(2 * N * V * isz + 12 * N, 4 * N * V,
                             torch.float32)
        xl = x.detach().requires_grad_(True)
        lib_out = F.cross_entropy(xl, lib_lab, reduction="none")
        rows.append(dict(
            kernel="softmax_ce_fwd", dtype=str(dtype)[6:],
            shape=f"N={N} V={V}", design=sce.fwd_design(V),
            max_abs_err=fwd_err, tol_ratio=fwd_ratio,
            ms=cuda_ms(lambda: sce.softmax_ce_fwd(x, lab), iters=n[0],
                       reps=n[1]),
            plain_ms=cuda_ms(lambda: sce.softmax_ce_fwd_plain(x, lab),
                             iters=n[0], reps=n[1]),
            library_ms=cuda_ms(lambda: F.cross_entropy(
                x, lib_lab, reduction="none"), iters=n[0], reps=n[1]),
            bound_ms=fbnd, bound_by=fby))
        rows.append(dict(
            kernel="softmax_ce_bwd", dtype=str(dtype)[6:],
            shape=f"N={N} V={V}", design=sce.bwd_design(V),
            max_abs_err=bwd_err, tol_ratio=bwd_ratio,
            ms=cuda_ms(lambda: sce.softmax_ce_bwd(x, lab, lse, dnll),
                       iters=n[0], reps=n[1]),
            plain_ms=cuda_ms(lambda: sce.softmax_ce_bwd_plain(
                x, lab, lse, dnll), iters=n[0], reps=n[1]),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_out, xl, dnll, retain_graph=True), iters=n[0], reps=n[1],
                graph=False),
            bound_ms=bbnd, bound_by=bby))
        del x, xl, lib_out
        torch.cuda.empty_cache()
    return rows


def check_ce_edges(dev, gen):
    """The CE kernels at their edges, fp32 and bf16: V 1, 2, 31, 33, 1,000
    and 1,001 (off the 16-byte vector), N 1, rows on each side of the
    crossing of the two designs in each direction (the widest row held,
    one element and one vector wider, at 1, 257 and 2,048 rows),
    logits one element off the 16-byte boundary, every label out of range,
    and a NaN in one row, which must reach that row's lse, nll and
    dlogits, as the plain versions have it, and no other row. Each
    launch's design held to the prediction, each pair run twice, bit for
    bit (``ce_pair``). Returns {kernel: worst error / tolerance} on the
    finite values."""
    from paddle_tpu_torch.ops.kernels import softmax_ce as sce
    worst = {"softmax_ce_fwd": 0.0, "softmax_ce_bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        vec = 16 // dtype.itemsize
        cases = [(N, V, False, 0) for N, V in (
            (300, 1), (300, 2), (65, 31), (65, 33), (128, 1000),
            (128, 1001), (1, 1000), (1, 5000), (3, 1001), (7, 30))]
        for hold in (sce.FWD_HOLD_MAX, sce.BWD_HOLD_MAX):
            cases += [(N, V, False, 0) for N in (1, 257, 2048)
                      for V in (hold, hold + 1, hold + vec)]
        cases += [(4, 50304, True, 0), (6, 2, True, 0), (6, 1000, True, 0),
                  (9, 1000, False, 1), (9, 50304, False, 1)]
        for N, V, out_of_range, off in cases:
            x = (2 * torch.randn(N * V + off, device=dev, generator=gen)
                 ).to(dtype)[off:].view(N, V)
            lab = torch.randint(0, V, (N,), device=dev, generator=gen,
                                dtype=torch.int32)
            if out_of_range:
                lab = torch.tensor([-100, V, -1, V + 7, -100, V][:N],
                                   dtype=torch.int32, device=dev)
            dnll = torch.randn(N, device=dev, generator=gen)
            nan_row = N > 2 and not out_of_range
            if nan_row:
                x[1, V // 2] = float("nan")
            nll, lse, dl = ce_pair(sce, x, lab, dnll)
            rnll, rlse = sce.softmax_ce_fwd_plain(x.float(), lab)
            rdl = sce.softmax_ce_bwd_plain(x.float(), lab, lse, dnll)
            what = f"softmax_ce N={N} V={V} {dtype} off {off}"
            if out_of_range and not torch.equal(nll, lse):
                raise AssertionError(f"{what}: out-of-range labels must "
                                     f"give nll = lse")
            nan_rows = torch.zeros(N, dtype=torch.bool, device=dev)
            if nan_row:
                nan_rows[1] = True
            for out, got, ref in (("nll", nll, rnll), ("lse", lse, rlse),
                                  ("dlogits", dl, rdl)):
                want = (nan_rows if got.dim() == 1
                        else nan_rows[:, None].expand(N, V))
                if not (torch.equal(got.isnan(), want)
                        and torch.equal(ref.isnan(), want)):
                    raise AssertionError(
                        f"{what}: NaN misplaced in {out}: kernel "
                        f"{got.isnan().nonzero()[:4].tolist()}, plain "
                        f"{ref.isnan().nonzero()[:4].tolist()}")
            fin = ~nan_rows
            worst["softmax_ce_fwd"] = max(
                worst["softmax_ce_fwd"],
                ce_fwd_ratio(nll[fin], lse[fin], rnll[fin], rlse[fin]))
            worst["softmax_ce_bwd"] = max(
                worst["softmax_ce_bwd"],
                rel_ratio(dl[fin], rdl[fin], CE_RTOL[dtype]))
    return worst


def nan_backward(fa, q, k, v, out, lse, causal, design, do):
    """Worst error / bwd_tol of the one-pass backward and the split pair
    (reporting `design`) on the finite values, for inputs with a NaN in
    row r = L // 2 of q[1, :, 2] (forward's out and lse given), after
    checking where each is NaN against the plain version: dq and dv
    exactly where it is, dk on every key that row sees. The plain version
    also turns the dk rows of keys the row does not see NaN (0 times a
    NaN delta); the kernels never walk the tiles above the diagonal, so
    there dk need only not be NaN where the plain version is finite."""
    L = q.shape[1]
    delta = fa.attention_delta(out, do)
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), lse,
                                       delta, do.float(), causal)
    one = launched_design(lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, do, causal), design, ("flash_attention_bwd",))
    split = launched_design(lambda: _split_bwd(
        fa, q, k, v, lse, delta, do, causal), design, SPLIT)
    seen = slice(0, L // 2 + 1 if causal else L)
    worst = 0.0
    for kind, got in (("one-pass", one), ("split", split)):
        nan = [g.isnan() for g in got]
        want = [r.isnan() for r in ref]
        if not (torch.equal(nan[0], want[0]) and torch.equal(nan[2], want[2])
                and torch.equal(nan[1][1, seen, 2], want[1][1, seen, 2])
                and not (nan[1] & ~want[1]).any() and nan[0].any()):
            raise AssertionError(
                f"{kind} backward {q.dtype} L={L} D={q.shape[-1]}: NaN in "
                f"q gives {[int(n.sum()) for n in nan]} NaN, the plain "
                f"version {[int(w.sum()) for w in want]}")
        for g, r in zip(got, ref):
            fin = ~(g.isnan() | r.isnan())
            if fin.any():
                worst = max(worst, max_err(g[fin], r[fin]) / bwd_tol(
                    q.dtype, r[fin]))
    return worst


#: the layer-norm edges (R, N): one row, a ragged N (1-element chunks), N
#: past the rows the kernels hold in registers (the stream instances),
#: N at the most each holds, many rows a warp, more rows than partial rows
LN_EDGES = ((1, 768), (3, 100), (3, 102), (5, 4096), (7, 1024), (9, 1536),
            (2, 2048), (2000, 48), (5000, 7))


def check_layer_norm_edges(dev, gen):
    """The layer-norm forward and backward at LN_EDGES, in fp32 and bf16
    with gamma in either type, then with x (and dy) one element off the
    16-byte boundary, R = 0 and a NaN in a row of x or an element of dy:
    each within tolerance of its plain version, run twice bit for bit,
    NaN exactly where the plain version has it. Returns {kernel: worst
    error / tolerance}."""
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    def randn(*shape, dtype, off=0):
        n = math.prod(shape)
        return torch.randn(n + off, device=dev, generator=gen).to(
            dtype)[off:].view(*shape)

    worst = {"layer_norm": 0.0, "layer_norm_bwd": 0.0}
    bad = []

    def one(x, g, dy, what):
        b = 0.1 * randn(g.shape[0], dtype=g.dtype)
        y = ln.layer_norm_fwd(x, g, b)
        grads = ln.layer_norm_bwd(x, g, dy)
        twice = (same_bits(y, ln.layer_norm_fwd(x, g, b))
                 and all(same_bits(a, c) for a, c in zip(
                     grads, ln.layer_norm_bwd(x, g, dy))))
        ref = ln.layer_norm_plain(x.float(), g.float(), b.float())
        keep = ~ref.isnan()
        fwd = max_err(y[keep], ref[keep]) / TOL[x.dtype] if keep.any() else 0
        bwd, nan_ok = ln_bwd_ratio(ln, x, g, dy, 1e-5, grads)
        if not (twice and nan_ok and torch.equal(y.isnan(), ref.isnan())):
            raise AssertionError(f"layer norm {what}: two runs differ "
                                 f"({not twice}) or NaN misplaced")
        worst["layer_norm"] = max(worst["layer_norm"], fwd)
        worst["layer_norm_bwd"] = max(worst["layer_norm_bwd"], bwd)
        if max(fwd, bwd) > 1.0:
            bad.append(f"{what}: forward /tol {fwd:.3f}, backward {bwd:.3f}")
        return grads

    for dtype in (torch.float32, torch.bfloat16):
        for gdt in (torch.float32, torch.bfloat16):
            for R, N in LN_EDGES:
                one(1 + randn(R, N, dtype=dtype),
                    1 + 0.1 * randn(N, dtype=gdt), randn(R, N, dtype=dtype),
                    f"R={R} N={N} {dtype}/{gdt}")
        def gamma(N):
            return 1 + 0.1 * randn(N, dtype=dtype)

        for R, N in ((6, 768), (6, 4096)):
            one(1 + randn(R, N, dtype=dtype, off=1), gamma(N),
                randn(R, N, dtype=dtype), f"x off 16 bytes R={R} N={N}")
            one(1 + randn(R, N, dtype=dtype), gamma(N),
                randn(R, N, dtype=dtype, off=1), f"dy off 16 bytes R={R}")
        dx, dg, db = one(randn(0, 768, dtype=dtype), gamma(768),
                         randn(0, 768, dtype=dtype), "R=0")
        if dx.shape != (0, 768) or dg.abs().max() != 0 or db.abs().max() != 0:
            raise AssertionError("layer norm backward R=0: dgamma and dbeta "
                                 "must be 0")
        for N in (768, 100):
            x, dy = 1 + randn(64, N, dtype=dtype), randn(64, N, dtype=dtype)
            x[5, 3] = float("nan")
            dy[9, 7] = float("nan")
            one(x, gamma(N), dy, f"NaN N={N} {dtype}")
    if bad:
        log("layer norm edges past their tolerance: " + "; ".join(bad))
    return worst


def check_edges(dev, gen):
    """Correctness only, at the limits each kernel claims beyond the main
    path's shapes: any R and N (layer norm, forward and backward: ragged N,
    N up to 4096 past the rows held in registers, many rows a warp,
    pointers off the 16-byte boundary, gamma in the other type, R = 0, a
    NaN in x or dy kept where the plain version keeps it, each run twice,
    bit for bit; `check_layer_norm_edges`); any L >= 1, ragged
    tails, Lk > Lq with the causal offset, D from 8 to 128 (flash, where
    D = 128 needs more than 48 KB of shared memory), rows off the 16-byte
    boundary (the CUDA-core design), each design as `fwd_design` and
    `bwd_design` name it and as the launches report it, the forward run
    twice, bit for bit, and a NaN (both signs) in q or v kept where the
    plain version keeps it (`nan_backward` for a NaN in q);
    ctx 0, one token,
    page and partition boundaries, contexts past the block table, one long
    lane among short ones, rows off the 16-byte width, repeated bit for
    bit (paged); the same flash shapes for the backward; the softmax CE's
    (`check_ce_edges`). Returns {kernel: worst error / tolerance}."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    def randn(*shape, dtype):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    worst = {**check_layer_norm_edges(dev, gen), **check_ce_edges(dev, gen),
             "flash_attention": 0.0, "flash_attention_bwd": 0.0,
             "paged_attention": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[dtype]
        for Lq, Lk, causal, D, off in (
                (1, 1, True, 64, 0), (16, 16, True, 64, 0),
                (100, 100, True, 64, 0), (37, 130, True, 64, 0),
                (100, 70, False, 64, 0), (50, 50, True, 128, 0),
                (20, 20, False, 8, 0), (100, 100, True, 64, 1),
                (33, 33, False, 128, 1)):
            # off 1: q's rows start one element off a 16-byte boundary,
            # which the tensor-core designs do not take
            q = randn(2 * Lq * 3 * D + off, dtype=dtype)[off:].view(
                2, Lq, 3, D)
            k = randn(2, Lk, 3, D, dtype=dtype)
            v = randn(2, Lk, 3, D, dtype=dtype)
            want = "cuda-core" if off or D not in (64, 128) else (
                "mma.sync" if dtype == torch.bfloat16 else "mma.sync-3xtf32")
            if fa.fwd_design(q, k, v) != want:
                raise AssertionError(f"flash forward D={D} off={off} "
                                     f"{dtype}: design "
                                     f"{fa.fwd_design(q, k, v)}, want {want}")
            out, lse = launched_design(
                lambda: fa.flash_attention_fwd(q, k, v, causal), want)
            again = fa.flash_attention_fwd(q, k, v, causal)
            if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
                raise AssertionError(f"flash forward Lq={Lq} Lk={Lk} D={D} "
                                     f"{dtype}: two runs differ")
            ref_out, ref_lse = fa.flash_attention_plain(
                q.float(), k.float(), v.float(), causal)
            err = max(max_err(out, ref_out), max_err(lse, ref_lse))
            worst["flash_attention"] = max(worst["flash_attention"],
                                           err / tol)
            do = randn(2, Lq, 3, D, dtype=dtype)
            got = launched_design(lambda: fa.flash_attention_bwd(
                q, k, v, out, lse, do, causal), want, ("flash_attention_bwd",))
            ref = fa.flash_attention_bwd_plain(
                q.float(), k.float(), v.float(), lse,
                fa.attention_delta(out, do), do.float(), causal)
            worst["flash_attention_bwd"] = max(
                worst["flash_attention_bwd"],
                *(max_err(g, r) / bwd_tol(dtype, r)
                  for g, r in zip(got, ref)))
        for L, causal, D, where, bits in (
                (100, True, 64, "q", 0x7fffffff), (20, False, 64, "v", -1),
                (50, False, 128, "v", 0x7fffffff), (40, True, 128, "q", -1)):
            # a NaN (0x7fffffff, or 0xffffffff: -NaN) in one row of q (its
            # output row and lse turn NaN) or one element of v (that
            # column of every row turns NaN): where the plain version
            # gives NaN the kernel must too, and agree elsewhere
            nan = torch.tensor(bits, dtype=torch.int32).view(torch.float32)
            q, k, v = randn(2, L, 3, 3, D, dtype=dtype).unbind(2)
            (q if where == "q" else v)[1, L // 2, 2, D // 3] = nan.item()
            want = ("mma.sync" if dtype == torch.bfloat16
                    else "mma.sync-3xtf32")
            out, lse = launched_design(
                lambda: fa.flash_attention_fwd(q, k, v, causal), want)
            ref_out, ref_lse = fa.flash_attention_plain(
                q.float(), k.float(), v.float(), causal)
            for got, ref in ((out, ref_out), (lse, ref_lse)):
                if not torch.equal(got.isnan(), ref.isnan()):
                    raise AssertionError(
                        f"flash forward {dtype} NaN in {where} L={L} D={D}: "
                        f"{int(got.isnan().sum())} NaN, the plain version "
                        f"{int(ref.isnan().sum())}")
                fin = ~ref.isnan()
                worst["flash_attention"] = max(
                    worst["flash_attention"],
                    max_err(got[fin], ref[fin]) / tol)
            if not ref_out.isnan().any():
                raise AssertionError("flash forward NaN edge: no NaN")
            if where == "q":
                worst["flash_attention_bwd"] = max(
                    worst["flash_attention_bwd"],
                    nan_backward(fa, q, k, v, out, lse, causal, want,
                                 randn(*q.shape, dtype=dtype)))
        for D in (40, 64, 128):
            page, pps = 16, 3
            ctx = torch.tensor([0, 1, 15, 16, 17, 48], dtype=torch.int32,
                               device=dev)
            W = ctx.numel()
            bt = (1 + torch.randperm(W * pps, device=dev, generator=gen)
                  ).to(torch.int32).reshape(W, pps)
            q = randn(W, 3, D, dtype=dtype)
            kp = randn(1 + W * pps, page, 3, D, dtype=dtype)
            vp = randn(1 + W * pps, page, 3, D, dtype=dtype)
            out = pa.paged_attention(q, kp, vp, bt, ctx)
            ref = pa.paged_attention_plain(q.float(), kp.float(), vp.float(),
                                           bt, ctx)
            if out[0].abs().max() != 0:
                raise AssertionError("paged_attention: ctx 0 must give 0")
            worst["paged_attention"] = max(worst["paged_attention"],
                                           max_err(out, ref) / tol)
        # the partition split: ctx 0 and 1, each side of a partition
        # boundary, the block table's end and past it; one lane at the
        # end among short ones. D 36 in bf16 (72-byte rows) and D 12 take
        # the element loads and the narrow lane groups; page 5 cuts
        # partitions of 255 tokens
        for D, page, pps in ((64, 16, 40), (36, 16, 40), (12, 5, 120)):
            part_pages, _ = pa.partitions(pps, page)
            part, cap = part_pages * page, pps * page
            for lens in ((0, 1, part - 1, part, part + 1, 2 * part - 1,
                          2 * part, 2 * part + 1, cap - 1, cap, cap + 37),
                         (cap, 1, 2, 3, 0)):
                ctx = torch.tensor(lens, dtype=torch.int32, device=dev)
                W = ctx.numel()
                bt = (1 + torch.randperm(W * pps, device=dev, generator=gen)
                      ).to(torch.int32).reshape(W, pps)
                q = randn(W, 2, D, dtype=dtype)
                kp = randn(1 + W * pps, page, 2, D, dtype=dtype)
                vp = randn(1 + W * pps, page, 2, D, dtype=dtype)
                out = pa.paged_attention(q, kp, vp, bt, ctx)
                again = pa.paged_attention(q, kp, vp, bt, ctx)
                ref = pa.paged_attention_plain(q.float(), kp.float(),
                                               vp.float(), bt, ctx)
                zero = [i for i, n in enumerate(lens) if n == 0]
                if out[zero].abs().max() != 0 or not torch.equal(out, again):
                    raise AssertionError(f"paged_attention D={D} page={page}"
                                         f" ctx={lens}: ctx 0 must give 0 "
                                         f"and two runs must agree bit for "
                                         f"bit")
                worst["paged_attention"] = max(worst["paged_attention"],
                                               max_err(out, ref) / tol)
    torch.cuda.synchronize()
    return worst


#: ResNet-50 kernels, each element against the plain version's fp32 value
#: before rounding: the output type's rounding, fp32 1e-5 and bf16 2^-7
#: (one ulp of bf16's 8-bit significand: the kernel rounds once, and a
#: value formed by another order or an FMA may round to the neighbour),
#: plus 1e-5 of the sum of the magnitudes of the terms that formed it
#: (x * k and c nearly cancel where a channel's variance is near 0).
#: Reductions are held to 1e-5 of the sum of their terms' magnitudes
#: (fp32 sums of up to 1.6M terms in another order).
RN_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
SUM_RTOL = 1e-5


def elem_ratio(got, ref, rtol, terms):
    """Worst |got - ref| / (rtol * |ref| + SUM_RTOL * terms), terms being
    the sum of the magnitudes of the terms that formed each element."""
    got, ref = got.float(), ref.float()
    tol = rtol * ref.abs() + SUM_RTOL * terms + 1e-30
    return float(((got - ref).abs() / tol).max())


def fp32_fwd(x, z, k, c, act):
    """The plain forward on fp32 copies: its value before rounding."""
    from paddle_tpu_torch.ops.kernels import fused_bn as fb
    return fb.bn_act_fwd_plain(x.float(), None if z is None else z.float(),
                               k, c, act)


def fp32_dx(x, y, dy, A, B, C0, act):
    """The plain dx on fp32 copies: its value before rounding."""
    from paddle_tpu_torch.ops.kernels import fused_bn as fb
    return fb.bn_bwd_dx_plain(x.float(), y, dy.float(), A, B, C0, act,
                              False)[0]


def bn_fwd_terms(x, z, k, c):
    t = (x.float() * k).abs() + c.abs()
    return t if z is None else t + z.float().abs()


def dx_terms(x, g, A, B, C0):
    return (A * g).abs() + (B * x.float()).abs() + C0.abs()


def sum_ratio(got, ref, terms_abs_sum):
    """Worst |got - ref| / (SUM_RTOL * sum of |terms|) over the columns."""
    return float(((got.float() - ref.float()).abs()
                  / (SUM_RTOL * terms_abs_sum.float() + 1e-30)).max())


def _bn_case(dev, gen, R, C, dtype, has_add):
    from paddle_tpu_torch.ops import _bn_common
    from paddle_tpu_torch.ops.kernels import fused_bn as fb
    x = (1.0 + torch.randn(R, C, device=dev, generator=gen)).to(dtype)
    z = (torch.randn(R, C, device=dev, generator=gen).to(dtype)
         if has_add else None)
    dy = torch.randn(R, C, device=dev, generator=gen).to(dtype)
    gamma = 1 + 0.1 * torch.randn(C, device=dev, generator=gen)
    beta = 0.1 * torch.randn(C, device=dev, generator=gen)
    mean, var = _bn_common._bn_stats(x, (0,))
    inv = torch.rsqrt(var + 1e-5)
    k, c = fb.fold_affine(gamma, beta, mean, inv)
    return x, z, dy, gamma, beta, mean, var, inv, k, c


def check_fused_bn(dev, gen, shapes):  # shapes: (N, H, W, C)
    """The fused-BN forward, reduce and dx kernels against their plain
    versions on the same inputs (the backward's on the kernel's y), with
    and without the residual add, ReLU on; library: the F.batch_norm +
    ReLU composition (its backward for the reduce and dx rows, which it
    computes together)."""
    from paddle_tpu_torch.ops.kernels import fused_bn as fb
    tF = torch.nn.functional
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for N, H, W, C in shapes:
            R = N * H * W
            for has_add in (False, True):
                x, z, dy, gamma, beta, mean, var, inv, k, c = _bn_case(
                    dev, gen, R, C, dtype, has_add)
                y = fb.bn_act_fwd(x, z, k, c, "relu")
                db, dg = fb.bn_bwd_reduce(x, y, dy, mean, inv, "relu")
                n = R
                A = inv * gamma
                B = -(A * inv * dg) / n
                C0 = -(A * db) / n - B * mean
                dx, dz = fb.bn_bwd_dx(x, y, dy, A, B, C0, "relu", has_add)
                torch.cuda.synchronize()
                ry = fb.bn_act_fwd_plain(x, z, k, c, "relu")
                g = torch.where(y > 0, dy.float(), 0.0)
                xhat = (x.float() - mean) * inv
                rdb, rdg = fb.bn_bwd_reduce_plain(x, y, dy, mean, inv,
                                                  "relu")
                rdx, rdz = fb.bn_bwd_dx_plain(x, y, dy, A, B, C0, "relu",
                                              has_add)
                f_ratio = elem_ratio(y, fp32_fwd(x, z, k, c, "relu"),
                                     RN_RTOL[dtype], bn_fwd_terms(x, z, k, c))
                r_ratio = max(sum_ratio(db, rdb, g.abs().sum(0)),
                              sum_ratio(dg, rdg, (g * xhat).abs().sum(0)))
                d_ratio = elem_ratio(dx, fp32_dx(x, y, dy, A, B, C0, "relu"),
                                     RN_RTOL[dtype], dx_terms(x, g, A, B, C0))
                if has_add:  # dz = g exactly
                    d_ratio = max(d_ratio, elem_ratio(
                        dz, rdz, 0.0, torch.zeros_like(g)))
                errs = (max_err(y, ry), max(max_err(db, rdb),
                                            max_err(dg, rdg)),
                        max(max_err(dx, rdx), 0.0 if dz is None
                            else max_err(dz, rdz)))
                del g, xhat, rdx, rdz
                isz = x.element_size()
                nz = 1 if has_add else 0
                shape = f"R={R} C={C} add={has_add}"
                fb_b, fb_by = bound_ms((2 + nz) * R * C * isz + 8 * C,
                                       4 * R * C, torch.float32)
                rb_b, rb_by = bound_ms(3 * R * C * isz + 16 * C,
                                       6 * R * C, torch.float32)
                db_b, db_by = bound_ms((4 + nz) * R * C * isz + 12 * C,
                                       5 * R * C, torch.float32)
                # library: F.batch_norm (+ z) + ReLU on the NCHW-shaped
                # channels-last view of the same memory, as a PyTorch
                # ResNet in channels_last runs it
                def cl(t):
                    return t.view(N, H, W, C).permute(0, 3, 1, 2)

                xl = x.detach().requires_grad_(True)
                gl = gamma.to(dtype).detach().requires_grad_(True)
                bl = beta.to(dtype).detach().requires_grad_(True)
                z4 = cl(z) if has_add else None

                def lib_fwd():
                    o = tF.batch_norm(cl(xl), None, None, gl, bl, True, 0.1,
                                      1e-5)
                    return torch.relu(o + z4 if has_add else o)

                lib_out = lib_fwd()
                lib_f = cuda_ms(lambda: lib_fwd().detach(), iters=5, reps=3,
                                graph=False)
                lib_b = cuda_ms(lambda: torch.autograd.grad(
                    lib_out, (xl, gl, bl), cl(dy), retain_graph=True),
                    iters=5, reps=3, graph=False)
                common = dict(dtype=str(dtype)[6:], shape=shape)
                rows.append(dict(
                    kernel="fused_bn_fwd", max_abs_err=errs[0],
                    tol_ratio=f_ratio,
                    ms=cuda_ms(lambda: fb.bn_act_fwd(x, z, k, c, "relu"),
                               iters=5, reps=3),
                    plain_ms=cuda_ms(lambda: fb.bn_act_fwd_plain(
                        x, z, k, c, "relu"), iters=5, reps=3),
                    library_ms=lib_f, bound_ms=fb_b, bound_by=fb_by,
                    **common))
                rows.append(dict(
                    kernel="fused_bn_bwd_reduce", max_abs_err=errs[1],
                    tol_ratio=r_ratio,
                    ms=cuda_ms(lambda: fb.bn_bwd_reduce(
                        x, y, dy, mean, inv, "relu"), iters=5, reps=3),
                    plain_ms=cuda_ms(lambda: fb.bn_bwd_reduce_plain(
                        x, y, dy, mean, inv, "relu"), iters=5, reps=3),
                    library_ms=lib_b, bound_ms=rb_b, bound_by=rb_by,
                    **common))
                rows.append(dict(
                    kernel="fused_bn_bwd_dx", max_abs_err=errs[2],
                    tol_ratio=d_ratio,
                    ms=cuda_ms(lambda: fb.bn_bwd_dx(
                        x, y, dy, A, B, C0, "relu", has_add), iters=5,
                        reps=3),
                    plain_ms=cuda_ms(lambda: fb.bn_bwd_dx_plain(
                        x, y, dy, A, B, C0, "relu", has_add), iters=5,
                        reps=3),
                    library_ms=lib_b, bound_ms=db_b, bound_by=db_by,
                    **common))
                del x, z, dy, y, dx, dz, lib_out, xl
                torch.cuda.empty_cache()
    return rows


#: the stride-1 1x1 convs of one ResNet-50 step at b128 224x224, (R, Cin,
#: Cout) -> launches a step: every bottleneck's first and last 1x1 conv
#: (the strided and downsample 1x1s are cuDNN's); resnet_train checks the
#: step's launches against it
RESNET_CONV_SHAPES = {
    (401408, 64, 64): 1, (401408, 256, 64): 2, (401408, 64, 256): 3,
    (401408, 256, 128): 1, (100352, 512, 128): 3, (100352, 128, 512): 4,
    (100352, 512, 256): 1, (25088, 1024, 256): 5, (25088, 256, 1024): 6,
    (25088, 1024, 512): 1, (6272, 2048, 512): 2, (6272, 512, 2048): 3}


def conv_shape(R, Cin, Cout):
    return f"R={R} Cin={Cin} Cout={Cout}"


def check_conv1x1(dev, gen, shapes, dtypes=(torch.float32, torch.bfloat16)):
    """The 1x1 conv + statistics kernel against its plain version: y per
    element to its dtype's rtol of |y| plus 1e-5 of the sum of its
    products' magnitudes (|x| @ |w|^T: the fp32 sums run in another
    order), and sum / sumsq to 1e-5 of the sums of |y| and y^2 of the
    kernel's stored y; a second run must repeat y and the sums bit for
    bit. fp32 at Cin >= 2048 (the longest chain of the split's products)
    is also held to the same gate against the product in fp64, with a
    single TF32 pass on the same inputs beside it (reported, and expected
    past the gate). Bounds at the design's peak (the fp32 design's
    3xTF32, with the CUDA-core bound beside it). Library: the product
    alone, x @ w^T (no single PyTorch call computes y and its
    statistics)."""
    from paddle_tpu_torch.ops.kernels import fused_conv_bn as fcb
    rows = []
    for dtype in dtypes:
        for R, Cin, Cout in shapes:
            x = torch.randn(R, Cin, device=dev, generator=gen).to(dtype)
            w = (torch.randn(Cout, Cin, device=dev, generator=gen)
                 / Cin ** 0.5).to(dtype)
            y, s, ss = fcb.conv1x1_stats(x, w)
            again = fcb.conv1x1_stats(x, w)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip((y, s, ss), again)):
                raise AssertionError(f"conv1x1_stats {conv_shape(R, Cin, Cout)}"
                                     f" {dtype}: two runs differ")
            del again
            ratio, err = conv_ratio(x, w, y, s, ss, dtype)
            design = fcb.kernel_design(x)
            extra = {}
            if dtype == torch.float32 and Cin >= 2048:
                extra["witnesses"] = {"fp64": conv_fp64_ratio(x, w, y)}
                extra["single_tf32_pass_ratio"] = conv_fp64_ratio(
                    x, w, (tf32_round(x) @ tf32_round(w).t()))
            isz = x.element_size()
            wt = w.t()
            rows.append(dict(
                kernel="conv1x1_stats", dtype=str(dtype)[6:],
                shape=conv_shape(R, Cin, Cout), design=design,
                max_abs_err=err, tol_ratio=ratio,
                library_call="x @ w^T, the product alone",
                ms=cuda_ms(lambda: fcb.conv1x1_stats(x, w), iters=5,
                           reps=3),
                plain_ms=cuda_ms(lambda: fcb.conv1x1_stats_plain(x, w),
                                 iters=5, reps=3),
                library_ms=cuda_ms(lambda: x @ wt, iters=5, reps=3),
                **design_bounds((R * Cin + Cout * Cin + R * Cout) * isz
                                + 8 * Cout, 2 * R * Cin * Cout + 3 * R * Cout,
                                dtype, design), **extra))
            del x, w, y
            torch.cuda.empty_cache()
    return rows


def tf32_round(t):
    """fp32 t rounded to the nearest TF32, ties away from zero (the
    kernels' hi)."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(
        torch.float32)


def conv_fp64_ratio(x, w, y):
    """Worst |y - x w^T| / (RN_RTOL |x w^T| + SUM_RTOL |x| |w|^T) of an
    fp32 y against the product in fp64."""
    ref = x.double() @ w.double().t()
    terms = x.double().abs() @ w.double().abs().t()
    tol = RN_RTOL[torch.float32] * ref.abs() + SUM_RTOL * terms + 1e-300
    return float(((y.double() - ref).abs() / tol).max())


def check_conv1x1_nan(dev, gen):
    """A NaN in x (one row) or in w (one output channel), fp32 and bf16, at
    a shape off every tile (R 300, Cin 520, Cout 72): y and the sums must
    be NaN exactly where the plain version's are, and nowhere else."""
    from paddle_tpu_torch.ops.kernels import fused_conv_bn as fcb
    for dtype in (torch.float32, torch.bfloat16):
        for where in ("x", "w"):
            R, Cin, Cout = 300, 520, 72
            x = torch.randn(R, Cin, device=dev, generator=gen).to(dtype)
            w = (torch.randn(Cout, Cin, device=dev, generator=gen)
                 / Cin ** 0.5).to(dtype)
            if where == "x":
                x[7, 13] = float("nan")
            else:
                w[5, 100] = float("nan")
            got = fcb.conv1x1_stats(x, w)
            want = fcb.conv1x1_stats_plain(x, w)
            torch.cuda.synchronize()
            for name, a, b in zip(("y", "sum", "sumsq"), got, want):
                if not (b.isnan().any() and torch.equal(a.isnan(),
                                                        b.isnan())):
                    raise AssertionError(
                        f"conv1x1_stats {dtype} NaN in {where}: {name} is "
                        f"NaN at {int(a.isnan().sum())} places, the plain "
                        f"version at {int(b.isnan().sum())}")


def conv_ratio(x, w, y, s, ss, dtype):
    """(worst error / tolerance, worst abs error) of one conv1x1_stats
    result against the plain version on the same inputs."""
    from paddle_tpu_torch.ops.kernels import fused_conv_bn as fcb
    ry, _, _ = fcb.conv1x1_stats_plain(x, w)
    ref32 = x.float() @ w.float().t()
    terms = x.float().abs() @ w.float().abs().t()
    tol = RN_RTOL[dtype] * ref32.abs() + SUM_RTOL * terms + 1e-30
    ratio = float(((y.float() - ref32).abs() / tol).max())
    yst = y.float()
    ratio = max(ratio, sum_ratio(s, yst.sum(0), yst.abs().sum(0)),
                sum_ratio(ss, (yst * yst).sum(0), (yst * yst).sum(0)))
    err = max(max_err(y, ry), max_err(s, yst.sum(0)),
              max_err(ss, (yst * yst).sum(0)))
    return ratio, err


def check_resnet_edges(dev, gen):
    """Correctness only, beyond the main path's shapes: R = 1, R off every
    tile, C from 8 to 2048 (13: the scalar route; 64 and 200: off the
    TPU's 128-lane gate), the add and no-ReLU forms; the 1x1 conv with
    R = 1, R off its 128-row tiles, Cin 8 and Cin off its k stage (64
    deep in bf16, 32 in fp32), Cout off its 64/128 column tile (16, 72,
    136, 200), Cin < Cout and Cin > Cout, each run twice, bit for bit,
    and a NaN in x or w (check_conv1x1_nan). Returns {kernel: worst
    error / tolerance}."""
    from paddle_tpu_torch.ops.kernels import fused_bn as fb
    from paddle_tpu_torch.ops.kernels import fused_conv_bn as fcb
    worst = {"fused_bn_fwd": 0.0, "fused_bn_bwd_reduce": 0.0,
             "fused_bn_bwd_dx": 0.0, "conv1x1_stats": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for R, C, has_add, act in ((1, 64, False, "relu"),
                                   (3, 8, True, "relu"),
                                   (1000, 200, True, "relu"),
                                   (4097, 13, False, None),
                                   (777, 2048, True, None),
                                   (130, 64, False, "relu")):
            x, z, dy, gamma, beta, mean, var, inv, k, c = _bn_case(
                dev, gen, R, C, dtype, has_add)
            y = fb.bn_act_fwd(x, z, k, c, act)
            worst["fused_bn_fwd"] = max(worst["fused_bn_fwd"], elem_ratio(
                y, fp32_fwd(x, z, k, c, act), RN_RTOL[dtype],
                bn_fwd_terms(x, z, k, c)))
            db, dg = fb.bn_bwd_reduce(x, y, dy, mean, inv, act)
            g = dy.float() if act is None else torch.where(
                y > 0, dy.float(), 0.0)
            xhat = (x.float() - mean) * inv
            rdb, rdg = fb.bn_bwd_reduce_plain(x, y, dy, mean, inv, act)
            worst["fused_bn_bwd_reduce"] = max(
                worst["fused_bn_bwd_reduce"],
                sum_ratio(db, rdb, g.abs().sum(0)),
                sum_ratio(dg, rdg, (g * xhat).abs().sum(0)))
            A, B, C0 = inv * gamma, 0.3 * inv, -0.1 * mean
            dx, dz = fb.bn_bwd_dx(x, y, dy, A, B, C0, act, has_add)
            r = elem_ratio(dx, fp32_dx(x, y, dy, A, B, C0, act),
                           RN_RTOL[dtype], dx_terms(x, g, A, B, C0))
            if has_add:
                r = max(r, elem_ratio(dz, g.to(dtype), 0.0,
                                      torch.zeros_like(g)))
            worst["fused_bn_bwd_dx"] = max(worst["fused_bn_bwd_dx"], r)
        for R, Cin, Cout in ((1, 64, 64), (100, 8, 16), (300, 520, 72),
                             (129, 2048, 512), (65, 64, 2048),
                             (1000, 8, 200), (4097, 72, 136)):
            x = torch.randn(R, Cin, device=dev, generator=gen).to(dtype)
            w = (torch.randn(Cout, Cin, device=dev, generator=gen)
                 / Cin ** 0.5).to(dtype)
            y, s, ss = fcb.conv1x1_stats(x, w)
            again = fcb.conv1x1_stats(x, w)
            if not all(torch.equal(a, b) for a, b in zip((y, s, ss), again)):
                raise AssertionError(f"conv1x1_stats {conv_shape(R, Cin, Cout)}"
                                     f" {dtype}: two runs differ")
            worst["conv1x1_stats"] = max(worst["conv1x1_stats"], conv_ratio(
                x, w, y, s, ss, dtype)[0])
    check_conv1x1_nan(dev, gen)
    torch.cuda.synchronize()
    return worst


# ------------------------------ phase 4: serve ------------------------------


def percentile(xs, p):
    return float(np.percentile(np.asarray(xs, np.float64), p))


#: the kernels of the serving path
SERVE_KERNELS = ("layer_norm", "flash_attention", "paged_attention")
#: kernel launches of one GPT-2 small forward (prefill or decode
#: iteration): two layer norms a block and the final one; flash attention
#: once a block in a prefill, paged attention once a block in a decode
#: iteration
SERVE_LN, SERVE_FLASH, SERVE_PAGED = 25, 12, 12
SERVE_ROUNDS = 3
SERVE_MAX_NEW = 32
DRILL_SAMPLING = dict(temperature=0.8, top_k=40, top_p=0.95)


def serve_prompts(cfg):
    """The phase's 66 prompts: 64 of 32-512 tokens and two longer than
    512 (the 1,024 prefill bucket)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size,
                            int(rng.integers(32, 513))).tolist()
               for _ in range(64)]
    return prompts + [rng.integers(1, cfg.vocab_size, n).tolist()
                      for n in (700, 960)]


def prefill_key(eng, prompt, sampled):
    """The fused engine's graph key of a prompt's prefill."""
    return ("prefill", eng._bucket_for(len(prompt)),
            "sampled" if sampled else "greedy")


def serve_round(eng, prompts, max_new=SERVE_MAX_NEW, sampling=None):
    """One run of `prompts` through `eng` from zeroed counters: tokens,
    latencies, host ms per decode iteration and per prefill and the run's
    launches, which must be exact (25 layer norms a forward, 12 flash
    forwards a prefill, 12 paged attentions an iteration), with no plain
    run and no composition; `prefill_keys`, the prefill graph key of each
    request."""
    from paddle_tpu_torch.ops import kernels
    it0 = eng.stats["iterations"]
    pf0 = eng.stats["prefills"]
    wall0 = eng.stats["decode_wall_s"]
    pwall0 = eng.stats["prefill_wall_s"]
    preplays0 = eng.stats["prefill_graph_replays"]
    replays0 = sum(eng.graph_replays.values())
    kernels.reset_stats()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=max_new, sampling=(
        None if sampling is None else sampling(i)))
        for i, p in enumerate(prompts)]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = kernels.all_stats()
    no_composed(f"serve {eng.decode_mode}")
    iters = eng.stats["iterations"] - it0
    prefills = eng.stats["prefills"] - pf0
    want = {"layer_norm": SERVE_LN * (iters + prefills),
            "flash_attention": SERVE_FLASH * prefills,
            "paged_attention": SERVE_PAGED * iters}
    for name in SERVE_KERNELS:
        st = stats[name]
        if st["kernel"] <= 0 or st["plain"] != 0 or (
                name in want and st["kernel"] != want[name]):
            raise AssertionError(
                f"serve {eng.decode_mode}: {name} counters {st}, want "
                f"{want.get(name, 'some')} kernel launches and no plain run "
                f"({iters} decode iterations, {prefills} prefills)")
    tokens = []
    for r in reqs:
        toks = r.result(timeout=0)
        if len(toks) != max_new or r.finish_reason != "length":
            raise AssertionError(f"request {r.rid}: {len(toks)} tokens, "
                                 f"{r.finish_reason}")
        tokens.append(toks)
    if eng.allocator.outstanding():
        raise AssertionError(f"leaked pages {eng.allocator.outstanding()}")
    tpot = [r.tpot_s for r in reqs]
    ttft = [r.ttft_s for r in reqs]
    n_tok = sum(map(len, tokens))
    return dict(
        mode=eng.decode_mode, requests=len(reqs), generated_tokens=n_tok,
        wall_s=wall, tokens_per_s=n_tok / wall,
        ttft_p50_ms=percentile(ttft, 50) * 1e3,
        ttft_p99_ms=percentile(ttft, 99) * 1e3,
        tpot_p50_ms=percentile(tpot, 50) * 1e3,
        tpot_p99_ms=percentile(tpot, 99) * 1e3,
        decode_iterations=iters, prefills=prefills,
        host_ms_per_iteration=(eng.stats["decode_wall_s"] - wall0)
        / max(1, iters) * 1e3,
        host_ms_per_prefill=(eng.stats["prefill_wall_s"] - pwall0)
        / max(1, prefills) * 1e3,
        prefill_graph_replays=eng.stats["prefill_graph_replays"]
        - preplays0,
        graph_replays=sum(eng.graph_replays.values()) - replays0,
        prefill_keys=[prefill_key(eng, p, sampling is not None and not
                                  sampling(i).greedy)
                      for i, p in enumerate(prompts)],
        launches=stats, designs=kernels.design_stats()), tokens


def prefill_wall_ms(eng, prompt):
    """Wall ms of one prefill of `prompt` alone (a request of one token,
    which finishes at its prefill): the host's copies, the forward (a
    replay in the fused engine) and the token back."""
    p0 = eng.stats["prefill_wall_s"]
    r = eng.submit(prompt, max_new_tokens=1)
    eng.run_until_idle()
    if len(r.result(timeout=0)) != 1:
        raise AssertionError("prefill probe: want one token")
    return (eng.stats["prefill_wall_s"] - p0) * 1e3


def decode_window_ops(eng, cfg, W=32, warm=2, window=8):
    """(device operations, device ms) per decode iteration at W lanes from
    torch.profiler: W short requests admitted and decoded `warm`
    iterations, then `window` iterations of pure decode profiled."""
    rng = np.random.default_rng(1)
    reqs = [eng.submit(rng.integers(1, cfg.vocab_size, 64).tolist(),
                       max_new_tokens=warm + window + 2) for _ in range(W)]
    for _ in range(warm):
        eng.step()

    def run():
        for _ in range(window):
            eng.step()
    ops, ms = device_ops(run)
    eng.run_until_idle()
    for r in reqs:
        r.result(timeout=0)
    return (None, None) if ops is None else (ops / window, ms / window)


def serve_drill(engines, cfg):
    """For each lane bucket W of 1-32 and each variant (greedy; sampled at
    temperature 0.8, top_k 40, top_p 0.95, seeds from 0): exactly W
    requests in every engine, tokens identical across the engines. Also
    returns the fused engine's prefill keys, one a request."""
    from paddle_tpu_torch.inference.sampling import SamplingParams
    rng = np.random.default_rng(2)
    out, keys = {}, []
    for W in engines[0].decode_buckets:
        prompts = [rng.integers(1, cfg.vocab_size,
                                int(rng.integers(16, 129))).tolist()
                   for _ in range(W)]
        for variant in ("greedy", "sampled"):
            sampling = None if variant == "greedy" else (
                lambda i: SamplingParams(seed=i, **DRILL_SAMPLING))
            runs = [serve_round(eng, prompts, sampling=sampling)
                    for eng in engines]
            if any(toks != runs[0][1] for _, toks in runs[1:]):
                raise AssertionError(f"drill W {W} {variant}: tokens differ "
                                     f"between the decode modes")
            out[f"W={W} {variant}"] = {
                r["mode"]: dict(host_ms_per_iteration=r[
                    "host_ms_per_iteration"], tpot_p50_ms=r["tpot_p50_ms"],
                    graph_replays=r["graph_replays"]) for r, _ in runs}
            keys += [k for r, _ in runs if r["mode"] == "fused"
                     for k in r["prefill_keys"]]
    return out, keys


def one_iteration_launches(eng, cfg, W=4):
    """The launches of ONE fused decode iteration at W lanes, counted
    through its graph's replay: exactly 25 layer norms and 12 paged
    attentions, and no other kernel, plain run or composition."""
    from paddle_tpu_torch.ops import kernels
    rng = np.random.default_rng(3)
    reqs = [eng.submit(rng.integers(1, cfg.vocab_size, 40).tolist(),
                       max_new_tokens=4) for _ in range(W)]
    eng.step()  # admission, W prefills and the first decode iteration
    replays = eng.graph_replays[(W, "greedy")]
    kernels.reset_stats()
    eng.step()
    got = {k: v for k, v in kernels.all_stats().items()
           if v["kernel"] or v["plain"]}
    want = {"layer_norm": {"kernel": SERVE_LN, "plain": 0},
            "paged_attention": {"kernel": SERVE_PAGED, "plain": 0}}
    if got != want or eng.graph_replays[(W, "greedy")] != replays + 1:
        raise AssertionError(f"one fused iteration launched {got}, want "
                             f"{want} through one replay")
    no_composed("serve one iteration")
    eng.run_until_idle()
    for r in reqs:
        r.result(timeout=0)
    return got


def loop_thread_run(model, cfg, eager_eng):
    """A fresh fused engine driven by its loop thread (start()/close()):
    its graphs are captured on that thread, and its tokens equal the
    eager engine's."""
    from paddle_tpu_torch.inference.serving import ServingEngine
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(16, 200)))
               .tolist() for _ in range(8)]
    eng = ServingEngine(model, max_batch=32, max_len=1024, page_size=16,
                        name="gpt2_small_thread")
    eng.start(poll_s=0.001)
    try:
        reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
        got = [r.result(timeout=300) for r in reqs]
    finally:
        eng.close()
    graphs = eng.status()["graphs"]
    ref_reqs = [eager_eng.submit(p, max_new_tokens=16) for p in prompts]
    eager_eng.run_until_idle()
    ref = [r.result(timeout=0) for r in ref_reqs]
    if got != ref or graphs < 1:
        raise AssertionError(f"loop thread: tokens equal {got == ref}, "
                             f"{graphs} graphs captured on the thread")
    return dict(requests=len(reqs), graphs=graphs)


def serve(model, cfg, card):
    """Phase 4: the eager and the fused decode step on the same weights.
    Paired rounds of the 66-prompt workload (eager then fused, tokens
    bit for bit), the lane-bucket drill, one iteration's launches, one
    fused run on the loop thread, the device operations a decode
    iteration at W 32, and the captured graphs (one per pair used, none
    recaptured, each replayed)."""
    from paddle_tpu_torch.inference.serving import ServingEngine
    engines = {mode: ServingEngine(model, max_batch=32, max_len=1024,
                                   page_size=16, name=f"gpt2_small_{mode}",
                                   decode_mode=mode)
               for mode in ("eager", "fused")}
    prompts = serve_prompts(cfg)
    # warm-up request (cuBLAS handles, first allocations); not counted
    for eng in engines.values():
        eng.generate(prompts[0][:40], max_new_tokens=4)
    # the fused engine's prefill graph keys, one a prefill
    uses = [prefill_key(engines["fused"], prompts[0][:40], False)]
    rounds = []
    for rnd in range(SERVE_ROUNDS):
        pair = {}
        for mode, eng in engines.items():
            pair[mode] = serve_round(eng, prompts)
            # the 960-token prompt's prefill alone, after the round
            pair[mode][0]["prefill_960_ms"] = prefill_wall_ms(eng,
                                                              prompts[-1])
        uses += pair["fused"][0]["prefill_keys"] + [
            prefill_key(engines["fused"], prompts[-1], False)]
        if pair["eager"][1] != pair["fused"][1]:
            raise AssertionError(f"serve round {rnd}: fused tokens differ "
                                 f"from eager tokens")
        if rounds and pair["fused"][1] != rounds[0]["fused"][1]:
            raise AssertionError(f"serve round {rnd}: tokens differ from "
                                 f"round 0")
        rounds.append(pair)
        for mode in engines:
            r = pair[mode][0]
            log(f"serve {mode} round {rnd}: {r['requests']} requests, "
                f"{r['generated_tokens']} tokens in {r['wall_s']:.3f} s "
                f"({r['tokens_per_s']:.1f} tok/s) TTFT p50 "
                f"{r['ttft_p50_ms']:.2f} ms p99 {r['ttft_p99_ms']:.2f} ms, "
                f"TPOT p50 {r['tpot_p50_ms']:.3f} ms p99 "
                f"{r['tpot_p99_ms']:.3f} ms, host "
                f"{r['host_ms_per_iteration']:.3f} ms a decode iteration "
                f"({r['decode_iterations']}), "
                f"{r['host_ms_per_prefill']:.3f} ms a prefill "
                f"({r['prefills']}; {r['prefill_graph_replays']} prefill "
                f"graph replays), the 960-token prefill "
                f"{r['prefill_960_ms']:.3f} ms wall, graph replays "
                f"{r['graph_replays']} [{card}]")
    main = rounds[-1]["fused"][0]
    # every fp32 prefill ran the forward on the TF32 tensor cores
    if main["designs"].get("flash_attention") != {
            "mma.sync-3xtf32": main["launches"]["flash_attention"]["kernel"]}:
        raise AssertionError(f"serve: flash forward designs "
                             f"{main['designs']}, want every launch on "
                             f"mma.sync-3xtf32")
    drill, drill_keys = serve_drill([engines["eager"], engines["fused"]],
                                    cfg)
    uses += drill_keys
    fused = engines["fused"]
    pairs = {(W, v) for W in fused.decode_buckets
             for v in ("greedy", "sampled")}
    decode = {k: n for k, n in fused.graph_replays.items()
              if k[0] != "prefill"}
    prefill = {k: n for k, n in fused.graph_replays.items()
               if k[0] == "prefill"}
    # each prefill graph captured at its key's first use and replayed at
    # every later one
    want_prefill = {k: uses.count(k) - 1 for k in set(uses)}
    n_graphs = len(pairs) + len(want_prefill)
    if set(decode) != pairs or min(decode.values()) < 1 or \
            prefill != want_prefill or len(fused._graphs) != n_graphs or \
            fused.stats["graph_captures"] != n_graphs or \
            fused.stats["prefill_graph_replays"] != sum(
                want_prefill.values()):
        raise AssertionError(
            f"serve: graphs {sorted(fused.graph_replays, key=str)} replays "
            f"{fused.graph_replays}, captures "
            f"{fused.stats['graph_captures']}; want one per pair of "
            f"{sorted(pairs)}, each replayed, and prefill replays "
            f"{want_prefill}")
    one_iter = one_iteration_launches(fused, cfg)
    ops = {mode: decode_window_ops(eng, cfg)
           for mode, eng in engines.items()}
    thread = loop_thread_run(model, cfg, engines["eager"])
    summary = {}
    for mode in engines:
        rs = [p[mode][0] for p in rounds]
        summary[mode] = {
            k: [r[k] for r in rs] for k in (
                "tpot_p50_ms", "tpot_p99_ms", "tokens_per_s", "ttft_p50_ms",
                "ttft_p99_ms", "host_ms_per_iteration",
                "host_ms_per_prefill", "prefill_960_ms")}
        summary[mode]["device_ops_per_iteration"] = ops[mode][0]
        summary[mode]["device_ms_per_iteration"] = ops[mode][1]
        log(f"serve {mode}: TPOT p50 "
            f"{', '.join(f'{x:.3f}' for x in summary[mode]['tpot_p50_ms'])}"
            f" ms, p99 "
            f"{', '.join(f'{x:.3f}' for x in summary[mode]['tpot_p99_ms'])}"
            f" ms, tokens/s "
            f"{', '.join(f'{x:.1f}' for x in summary[mode]['tokens_per_s'])}"
            f", host ms a decode iteration "
            f"{', '.join(f'{x:.3f}' for x in summary[mode]['host_ms_per_iteration'])}"
            f", TTFT p50 "
            f"{', '.join(f'{x:.2f}' for x in summary[mode]['ttft_p50_ms'])}"
            f" ms, p99 "
            f"{', '.join(f'{x:.2f}' for x in summary[mode]['ttft_p99_ms'])}"
            f" ms, host ms a prefill "
            f"{', '.join(f'{x:.3f}' for x in summary[mode]['host_ms_per_prefill'])}"
            f", the 960-token prefill "
            f"{', '.join(f'{x:.3f}' for x in summary[mode]['prefill_960_ms'])}"
            f" ms; at W 32: {ops[mode][0]} device operations, "
            f"{ops[mode][1]} device ms an iteration [{card}]")
    log(f"serve fused: {len(fused._graphs)} graphs ({len(want_prefill)} "
        f"prefill: {json.dumps({f'{k[1]} {k[2]}': n for k, n in sorted(prefill.items())})} "
        f"replays), pool "
        f"{fused.graph_pool_bytes} bytes (reserved during the captures); "
        f"one iteration's launches {json.dumps(one_iter)}; loop thread "
        f"{thread} [{card}]")
    log(f"serve: launches {json.dumps(main['launches'])}")
    res = dict(main, card=card, rounds=[{m: p[m][0] for m in p}
                                        for p in rounds],
               summary=summary, drill=drill, one_iteration=one_iter,
               graphs=len(fused._graphs),
               graph_replays={" ".join(map(str, k)): n for k, n in
                              sorted(fused.graph_replays.items(), key=str)},
               graph_pool_bytes=fused.graph_pool_bytes, loop_thread=thread)
    for eng in engines.values():
        eng.close()
    return res, prompts


# ------------------------- phase 5: CPU cross-check --------------------------


def cross_check(model, cfg, prompts):
    """Prefill + 8 teacher-forced decode steps on the card and on the CPU
    (plain versions) from the same weights; fp32 atol 2e-3 on the logits
    (12 layers of fp32 sums in another order, vocab 50304)."""
    from paddle_tpu_torch.models.gpt import GPT
    cpu = GPT(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.eval()
    picks = [prompts[1], prompts[-1]]
    steps = 8
    worst, agree, total = 0.0, 0, 0
    with torch.no_grad():
        for p in picks:
            logs = {}
            for name, m in (("gpu", model), ("cpu", cpu)):
                cache = m.init_cache(1, 1024, page_size=16)
                cache.block_tables.copy_(torch.arange(
                    1, 1 + cache.pages_per_seq, dtype=torch.int32)[None])
                bucket = 1 << (len(p) - 1).bit_length()
                ids = torch.zeros(1, bucket, dtype=torch.long)
                ids[0, :len(p)] = torch.tensor(p)
                lg, _ = m.forward_prefill(ids.to(m.device), cache, 0, len(p))
                out = [lg[0].cpu()]
                logs[name] = (m, cache, out)
            # teacher forcing: both sides are fed the card's tokens
            for _ in range(steps):
                tok = int(logs["gpu"][2][-1].argmax())
                for name in ("gpu", "cpu"):
                    m, cache, out = logs[name]
                    lg, _ = m.forward_decode(
                        torch.tensor([tok], device=m.device), cache)
                    out.append(lg[0].cpu())
            for g, c in zip(logs["gpu"][2], logs["cpu"][2]):
                worst = max(worst, float((g - c).abs().max()))
                agree += int(int(g.argmax()) == int(c.argmax()))
                total += 1
    log(f"cpu: max |logit(card) - logit(cpu)| {worst:.3e} (atol 2e-3); "
        f"token agreement {agree}/{total}")
    if not worst <= 2e-3:
        raise AssertionError(f"card and CPU logits differ by {worst}")
    return dict(max_abs_err=worst, atol=2e-3, token_agreement=agree,
                steps=total)


# ------------------------ phase 23: serve_control -------------------------

CONTROL_REQUESTS, CONTROL_NEW, CONTROL_PROBE = 8, 16, (2, 128)


def counts_since(before):
    """Kernel launch counters now, less `before` (an `all_stats()`)."""
    from paddle_tpu_torch.ops import kernels
    return {k: {c: n - before[k][c] for c, n in st.items()}
            for k, st in kernels.all_stats().items()}


def control_run(eng, prompts, steps_before=0, act=None):
    """The phase's requests through `eng` (greedy, CONTROL_NEW tokens
    each), `act()` after `steps_before` iterations; their tokens."""
    reqs = [eng.submit(p, max_new_tokens=CONTROL_NEW) for p in prompts]
    for _ in range(steps_before):
        eng.step()
    if act is not None:
        act()
    eng.run_until_idle()
    return [r.result(timeout=0) for r in reqs]


def serve_control(cfg, card):
    """Phase 23: the serving control plane on one fused engine at phase
    4's widths, the captured prefill and decode graphs kept valid through
    a swap, a rollback and a restart (see the module docstring)."""
    from paddle_tpu_torch.inference import EngineSuspended, MemoryGovernor
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.ops import kernels
    kw = dict(max_batch=32, max_len=1024, page_size=16)
    models = []
    for seed in (0, 1):
        m = GPT(cfg, device="cuda",
                generator=torch.Generator().manual_seed(seed))
        m.eval()
        models.append(m)
    model, other = models
    candidate = {k: p.detach() for k, p in other.named_parameters()}
    original_weights = {k: p.detach().clone()
                        for k, p in model.named_parameters()}
    ptrs = {k: p.data_ptr() for k, p in model.named_parameters()}
    rng = np.random.default_rng(23)
    # prompts of 40-48 tokens: with the tokens generated before a restart
    # they stay in the 64-token prompt bucket
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(40, 49)))
               .tolist() for _ in range(CONTROL_REQUESTS)]
    eng = ServingEngine(model, name="gpt2_small_control", **kw)
    kernels.reset_stats()
    res = {"card": card}
    original = control_run(eng, prompts)
    captures = eng.stats["graph_captures"]

    def no_capture(what):
        if eng.stats["graph_captures"] != captures:
            raise AssertionError(f"serve_control: {what} captured "
                                 f"{eng.stats['graph_captures'] - captures}"
                                 f" graphs")

    def live_is(weights, what):
        for k, p in model.named_parameters():
            if p.data_ptr() != ptrs[k] or not torch.equal(p, weights[k]):
                raise AssertionError(f"serve_control: {what}: parameter {k} "
                                     f"moved or holds other values")

    # a swap while every request is in flight
    mid = control_run(eng, prompts, 3, lambda: eng.request_swap(
        candidate, step=1, source="chip_smoke"))
    live_is(candidate, "after the swap")
    res["swap"] = dict(eng.last_swap)
    swapped = control_run(eng, prompts)
    fresh = ServingEngine(other, name="gpt2_small_fresh", **kw)
    want = control_run(fresh, prompts)
    fresh.close()
    del fresh
    if swapped != want or mid == original:
        raise AssertionError(f"serve_control: tokens after the swap equal "
                             f"a fresh engine's on the new weights: "
                             f"{swapped == want}; the swap changed the "
                             f"in-flight requests: {mid != original}")
    no_capture("the swap")
    # the rollback
    eng.rollback_weights()
    back = control_run(eng, prompts)
    live_is(original_weights, "after the rollback")
    if back != original:
        raise AssertionError("serve_control: tokens after the rollback "
                             "differ from the original weights'")
    res["rollback"] = dict(eng.last_swap)
    no_capture("the rollback")
    # the canary: live and candidate weights, its launches counted
    probe = rng.integers(1, cfg.vocab_size, CONTROL_PROBE)
    before = kernels.all_stats()
    ppl = (eng.run_canary(probe), eng.run_canary(probe, candidate))
    canary = {k: v for k, v in counts_since(before).items()
              if v["kernel"] or v["plain"]}
    want_canary = {"layer_norm": {"kernel": 2 * SERVE_LN, "plain": 0},
                   "flash_attention": {"kernel": 2 * SERVE_FLASH,
                                       "plain": 0},
                   "softmax_ce_fwd": {"kernel": 2, "plain": 0}}
    if canary != want_canary or not all(map(math.isfinite, ppl)):
        raise AssertionError(f"serve_control: canary launches {canary}, "
                             f"want {want_canary}; perplexities {ppl}")
    live_is(original_weights, "after the canary")
    res["canary"] = dict(perplexity_live=ppl[0], perplexity_candidate=ppl[1],
                         probe=list(CONTROL_PROBE), launches=canary)
    # restart mid-decode
    info = {}
    restarted = control_run(eng, prompts, 3,
                            lambda: info.update(eng.restart(
                                reason="chip_smoke")))
    if restarted != original or info["requeued"] != CONTROL_REQUESTS:
        raise AssertionError(f"serve_control: restart {info}; tokens equal "
                             f"an unrestarted run's: {restarted == original}")
    no_capture("the restart")
    res["restart"] = info
    # the admission gates
    eng.suspend(retry_after_s=2.5)
    try:
        eng.submit(prompts[0], max_new_tokens=2)
        raise AssertionError("serve_control: a suspended engine admitted")
    except EngineSuspended as e:
        if e.retry_after_s != 2.5:
            raise AssertionError(f"serve_control: retry_after_s "
                                 f"{e.retry_after_s}")
    eng.resume_admissions()
    eng.set_queue_limit(2)
    capped = [eng.submit(p, max_new_tokens=2) for p in prompts[:2]]
    try:
        eng.submit(prompts[2], max_new_tokens=2)
        raise AssertionError("serve_control: the queue cap let a third in")
    except RuntimeError as e:
        if "shed cap" not in str(e):
            raise
    eng.set_queue_limit(None)
    eng.run_until_idle()
    for r in capped:
        r.result(timeout=0)
    free0 = eng.allocator.free_pages
    parked = eng.shrink_pool(0.5)
    shrunk = eng.allocator.free_pages
    restored = eng.restore_pool()
    if not (parked == (eng.cache.num_pages - 1) // 2 == restored
            and shrunk == free0 - parked
            and eng.allocator.free_pages == free0):
        raise AssertionError(f"serve_control: shrink parked {parked}, "
                             f"restore returned {restored}; free {free0} "
                             f"-> {shrunk} -> {eng.allocator.free_pages}")
    res["pool"] = dict(free_pages=free0, parked=parked, restored=restored)
    # the governor on the card's own memory reading
    gov = MemoryGovernor(limit_bytes=1, engines=lambda: [eng],
                         retry_after_s=2.5)
    in_use = gov.in_use_bytes([eng])
    gov.limit_bytes = in_use - 1
    acts = [gov.tick(), gov.tick()]
    gov.limit_bytes = 2 * in_use
    acts += [gov.tick(), gov.tick()]
    names = [a and a["action"] for a in acts]
    if names != ["shrink_pool", "suspend", "resume", "restore_pool"] or \
            eng.allocator.reserved_pages or eng.status()["suspended"]:
        raise AssertionError(f"serve_control: governor actions {names}")
    res["governor"] = dict(in_use_bytes=in_use, actions=names,
                           parked_pages=acts[0]["parked_pages"])
    stats = kernels.all_stats()
    no_composed("serve_control")
    for name in ("layer_norm", "flash_attention", "paged_attention",
                 "softmax_ce_fwd"):
        if stats[name]["kernel"] <= 0 or stats[name]["plain"]:
            raise AssertionError(f"serve_control: {name} {stats[name]}")
    res.update(launches=stats, graphs=len(eng._graphs),
               graph_captures=eng.stats["graph_captures"],
               swaps=eng.stats["swaps"], restarts=eng.stats["restarts"])
    log(f"serve_control: swap with {res['swap']['in_flight']} requests in "
        f"flight, pause_s {res['swap']['pause_s']:.6f}, rollback pause_s "
        f"{res['rollback']['pause_s']:.6f}; later tokens equal a fresh "
        f"engine's on the new weights, the rollback's the original's; "
        f"canary perplexity {ppl[0]:.4f} live, {ppl[1]:.4f} candidate "
        f"(launches {json.dumps(canary)}); restart requeued "
        f"{info['requeued']}, tokens as unrestarted; {captures} graphs, "
        f"none captured again; suspension, queue cap, pool {parked} pages "
        f"parked and restored; governor at {in_use} bytes in use: "
        f"{', '.join(names)} [{card}]")
    eng.close()
    del eng, model, other, models, candidate, original_weights
    free_card()
    return res


# ------------------------------ phase 6: train ------------------------------

TRAIN_B, TRAIN_L = 8, 1024
TRAIN_WARMUP, TRAIN_STEPS = 2, 6
BF16_PEAK = 989e12
#: launches per training step of GPT-2 small (12 layers): two layer norms a
#: block plus the final one, one attention a block, one loss
PER_STEP = {"layer_norm": 25, "layer_norm_bwd": 25, "flash_attention": 12,
            "flash_attention_bwd": 12, "softmax_ce_fwd": 1,
            "softmax_ce_bwd": 1}


def model_flops(model, B, L):
    """bench.py's model FLOPs of one step: 6 per parameter and token, plus
    attention's 12 * layers * B * L^2 * hidden."""
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    return (6 * n_params * B * L
            + 12 * cfg.num_layers * B * L * L * cfg.hidden_size)


# ------------- the captured training step: gate and paired timing -------------

#: steps of each run of a capture gate (the long path's are seconds each)
GATE_STEPS, GATE_STEPS_LONG = 10, 3
#: paired rounds of the captured step against the uncaptured one
CAPTURE_ROUNDS = 3
_INT_OF = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}


def bits_equal(a, c):
    """torch.equal on the bits of floating tensors (NaN equals NaN of the
    same bits), plain torch.equal otherwise."""
    if a.dtype != c.dtype or a.shape != c.shape:
        return False
    if a.is_floating_point():
        it = _INT_OF[a.element_size()]
        return torch.equal(a.contiguous().view(it), c.contiguous().view(it))
    return torch.equal(a, c)


@contextlib.contextmanager
def deterministic_steps():
    """Inside: no run-to-run variation that capture has nothing to do
    with. The flash backward takes the split pair (no atomics) where the
    one-pass kernel adds dq with atomics in a varying order, and PyTorch
    and cuDNN their deterministic algorithms (an embedding's backward
    over one repeated index, BERT's token types, varies otherwise);
    uninitialised memory is left unfilled, as outside."""
    import torch.utils.deterministic as tud
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    saved = (fa._FUSED_BWD_DQ_BYTES, torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             tud.fill_uninitialized_memory)
    fa._FUSED_BWD_DQ_BYTES = 0
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    tud.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # cuBLAS's workspace setting
            yield
    finally:
        (fa._FUSED_BWD_DQ_BYTES, torch.backends.cudnn.deterministic, det,
         warn, tud.fill_uninitialized_memory) = saved
        torch.use_deterministic_algorithms(det, warn_only=warn)


def split_per_step(per_step):
    """A path's launches a step under deterministic_steps: the one-pass
    backward's moved to the split pair's dq and dk/dv kernels."""
    out = dict(per_step)
    for one in ("flash_attention_bwd", "flash_attention_bwd_masked"):
        n = out.pop(one, 0)
        for half in ("_dq", "_dkv"):
            name = one.replace("_bwd", "_bwd" + half)
            if n:
                out[name] = out.get(name, 0) + n
    return out


def step_state(step):
    """{name: clone} of a TrainStep's masters, optimizer slots and
    buffers."""
    out = {f"param {k}": v.detach().clone() for k, v in step.params.items()}
    out.update({f"slot {k}.{s}": v.clone()
                for k, d in step.opt_state.items() for s, v in d.items()})
    out.update({f"buffer {k}": v.clone() for k, v in step.buffers.items()})
    return out


def graph_summary(step):
    """A TrainStep's graph counters, keys as text."""
    st = step.stats
    return dict(captures=st["graph_captures"],
                replays={f"{v} {[list(s[1]) for s in sig if s[0] != 'value']}":
                         n for (sig, v), n in st["graph_replays"].items()},
                pool_bytes=st["graph_pool_bytes"])


def capture_gate(path, build, batches, steps, per_step, after_step=None,
                 seed=0, twice=0):
    """The captured TrainStep against the uncaptured one (phases 6, 8,
    10, 14, 21, 22): ``build()`` makes the step from the same seeded
    weights twice, one after the other, and each runs ``steps`` steps
    over ``batches`` in turn, the default generators seeded alike before
    each (dropout's masks), ``after_step(step)`` after every step (a
    scheduler's): first uncaptured (``_step_uncaptured``), then captured.
    Both run under deterministic_steps. Raises unless the losses and
    every master, slot and buffer agree bit for bit, each run's launches
    are exact a step (``per_step``, the split pair's where the path has
    the one-pass backward) with no plain run and no composition, and the
    captured run captured each (signature, variant) once and replayed it
    the other times. With ``twice``, two more uncaptured runs of that
    many steps outside deterministic_steps report whether the path
    repeats bit for bit at all (``uncaptured_repeats``)."""
    from paddle_tpu_torch.ops import kernels
    want = split_per_step(per_step)

    def run(captured, n, det=True):
        torch.manual_seed(seed)
        step = build()
        fn = step if captured else step._step_uncaptured
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_stats()
        losses = []
        with deterministic_steps() if det else contextlib.nullcontext():
            for i in range(n):
                losses.append(fn(*batches[i % len(batches)]))
                if after_step is not None:
                    after_step(step)
            torch.cuda.synchronize()
        out = dict(losses=torch.stack(losses).cpu(), state=step_state(step),
                   stats=kernels.all_stats(),
                   composed=kernels.composed_stats(),
                   graphs=graph_summary(step),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   peak_above_gb=(torch.cuda.max_memory_allocated()
                                  - base) / 1e9)
        step.release_graphs()
        del step, fn, losses
        torch.cuda.empty_cache()
        return out

    plain = run(False, steps)
    graphed = run(True, steps)
    diff = [k for k, v in plain["state"].items()
            if not bits_equal(v, graphed["state"][k])]
    same_losses = bits_equal(plain["losses"], graphed["losses"])
    for name, r in (("uncaptured", plain), ("captured", graphed)):
        for k, st in r["stats"].items():
            if st["plain"] or st["kernel"] != want.get(k, 0) * steps:
                raise AssertionError(f"{path} gate: {name} run's {k} "
                                     f"counters {st}, want "
                                     f"{want.get(k, 0)} a step")
        if any(r["composed"].values()):
            raise AssertionError(f"{path} gate: {name} run composed "
                                 f"{r['composed']}")
    g = graphed["graphs"]
    if (g["captures"] != len(g["replays"])
            or sum(g["replays"].values()) != steps - g["captures"]):
        raise AssertionError(f"{path} gate: graphs {g}")
    res = dict(steps=steps, losses=graphed["losses"].tolist(),
               losses_bit_for_bit=same_losses,
               state_tensors=len(plain["state"]), state_differing=diff,
               launches_per_step=want, graphs=g,
               peak_gb_uncaptured=plain["peak_gb"],
               peak_gb_captured=graphed["peak_gb"],
               peak_above_start_gb_uncaptured=plain["peak_above_gb"],
               peak_above_start_gb_captured=graphed["peak_above_gb"])
    del plain, graphed
    if twice:
        a, b = run(False, twice, det=False), run(False, twice, det=False)
        res["uncaptured_repeats"] = dict(
            steps=twice, losses=bits_equal(a["losses"], b["losses"]),
            state_differing=sum(not bits_equal(v, b["state"][k])
                                for k, v in a["state"].items()))
        del a, b
    torch.cuda.empty_cache()
    log(f"{path} gate: captured against uncaptured over {steps} steps "
        f"(deterministic_steps): losses bit for bit {same_losses}, "
        f"{len(diff)} of {res['state_tensors']} masters/slots/buffers "
        f"differ; graphs {json.dumps(g)}; peak {res['peak_gb_uncaptured']:.2f}"
        f" -> {res['peak_gb_captured']:.2f} GB"
        + (f"; two uncaptured runs at the path's own settings: "
           f"{json.dumps(res['uncaptured_repeats'])}" if twice else ""))
    if not same_losses or diff:
        raise AssertionError(f"{path} gate: captured and uncaptured differ:"
                             f" losses {same_losses}, tensors {diff[:8]}")
    return res


def paired_capture(path, step, batch, n, card, rounds=CAPTURE_ROUNDS,
                   after_step=None):
    """The captured step against the uncaptured one on the same TrainStep,
    in turns (phase 18's form): each round a run of ``n`` captured steps,
    then ``n`` uncaptured, each waited for once at its end. Step ms: a
    run's wall over ``n``; host ms: the calls' own time over ``n`` (the
    host returns before the card finishes a captured step). Then one
    profiled step of each: device operations and busy ms. With the
    graph pool's bytes and the peak memory so far."""
    def timed(fn):
        torch.cuda.synchronize()
        host = 0.0
        t0 = time.perf_counter()
        for _ in range(n):
            t1 = time.perf_counter()
            fn(*batch)
            host += time.perf_counter() - t1
            if after_step is not None:
                after_step(step)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n, host * 1e3 / n

    ms = {"captured": [], "uncaptured": []}
    host = {"captured": [], "uncaptured": []}
    for _ in range(rounds):
        for name, fn in (("captured", step), ("uncaptured",
                                              step._step_uncaptured)):
            a, b = timed(fn)
            ms[name].append(a)
            host[name].append(b)
    # a call's own host time with the card idle (a wait before each): in
    # a run the host blocks in the launch once the card's queue is full
    idle = {"captured": [], "uncaptured": []}
    for _ in range(rounds):
        for name, fn in (("captured", step), ("uncaptured",
                                              step._step_uncaptured)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*batch)
            idle[name].append((time.perf_counter() - t0) * 1e3)
            if after_step is not None:
                after_step(step)
    ops = {}
    for name, fn in (("captured", step), ("uncaptured",
                                          step._step_uncaptured)):
        ops[name] = device_ops(lambda: fn(*batch))
        if after_step is not None:
            after_step(step)
    res = dict(steps=n, rounds=rounds, step_ms=ms, host_ms=host,
               host_ms_idle=idle,
               device_ops={k: v[0] for k, v in ops.items()},
               device_busy_ms={k: v[1] for k, v in ops.items()},
               graph_pool_bytes=step.stats["graph_pool_bytes"],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               card=card)
    log(f"{path} capture: step ms captured {json.dumps(ms['captured'])} "
        f"uncaptured {json.dumps(ms['uncaptured'])} (runs of {n}, in "
        f"turns); host ms a step captured {json.dumps(host['captured'])} "
        f"uncaptured {json.dumps(host['uncaptured'])}; a call's host ms "
        f"with the card idle captured {json.dumps(idle['captured'])} "
        f"uncaptured {json.dumps(idle['uncaptured'])}; device ops / busy "
        f"ms a step captured {ops['captured'][0]} / {ops['captured'][1]} "
        f"uncaptured {ops['uncaptured'][0]} / {ops['uncaptured'][1]}; "
        f"graph pool {res['graph_pool_bytes']} bytes, peak "
        f"{res['peak_mem_gb']:.2f} GB [{card}]")
    return res


def train(cfg, card):
    """TrainStep + AdamW under O2 bf16 at b8 s1024 on the card; returns
    step times, losses and launches per step."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    def build():
        net = GPT(cfg, device="cuda",
                  generator=torch.Generator().manual_seed(0))
        return TrainStep(net, F.cross_entropy, optimizer.AdamW(
            learning_rate=1e-4, parameters=net.parameters(),
            weight_decay=0.01), amp_dtype=torch.bfloat16)

    torch.cuda.reset_peak_memory_stats()
    step = build()
    model = step.layer
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        TRAIN_B, TRAIN_L))).to("cuda")
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        TRAIN_B, TRAIN_L))).to("cuda")
    losses = [float(step(ids, labels)) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    kernels.reset_stats()
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    stats = kernels.all_stats()
    no_composed("train")
    ce_designs("train")
    per_step = {k: v["kernel"] / TRAIN_STEPS for k, v in stats.items()}
    for name, want in PER_STEP.items():
        st = stats[name]
        if st["plain"] != 0 or st["kernel"] != want * TRAIN_STEPS:
            raise AssertionError(f"train: {name} counters {st}, want "
                                 f"{want} kernel launches a step and no "
                                 f"plain run")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    step_ms = float(np.median(times)) * 1e3
    flops = model_flops(model, TRAIN_B, TRAIN_L)
    res = dict(batch=TRAIN_B, seq=TRAIN_L, steps=TRAIN_STEPS,
               warmup=TRAIN_WARMUP, losses=losses,
               step_ms=step_ms, step_ms_all=[t * 1e3 for t in times],
               tokens_per_s=TRAIN_B * TRAIN_L / (step_ms / 1e3),
               model_flops=flops, mfu=flops / (step_ms / 1e3) / BF16_PEAK,
               launches=stats, launches_per_step=per_step,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               card=card)
    log(f"train: GPT-2 small O2 bf16 b{TRAIN_B} s{TRAIN_L}: step "
        f"{step_ms:.2f} ms (median of {TRAIN_STEPS}), "
        f"{res['tokens_per_s']:.1f} tokens/s, MFU {res['mfu']:.4f} "
        f"(model FLOPs {flops:.4e} over {BF16_PEAK:.0e}) [{card}]")
    log(f"train: loss {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"train: launches per step {json.dumps(per_step)}")
    res["graphs"] = graph_summary(step)
    res["capture"] = paired_capture("train", step, (ids, labels),
                                    TRAIN_STEPS, card)
    step.release_graphs()
    del step, model
    torch.cuda.empty_cache()
    other = tuple(torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        TRAIN_B, TRAIN_L))).to("cuda") for _ in range(2))
    res["gate"] = capture_gate("train", build, [(ids, labels), other],
                               GATE_STEPS, PER_STEP, twice=2)
    return res


def capture_edges(card):
    """The captured step's edges on GPTConfig.tiny()'s widths on the card
    (its kernels included): a ``loss_fn`` that reads a value back
    (``.item()``) makes TrainStep raise, naming the capture, and return no
    loss; then dropout 0.1 inside remat "full" (checkpoint's RNG stash
    runs inside the capture) with a dropout in the loss that draws from an
    explicit CUDA generator (registered with the graph), captured against
    uncaptured over 4 steps from the same seeds: losses, masters and slots
    bit for bit, and the generator's state after the run alike."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import functional as F
    cfg = GPTConfig.tiny()
    cfg.dropout, cfg.remat = 0.1, "full"
    rng = np.random.default_rng(0)
    ids, labels = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        4, 64))).cuda() for _ in range(2))

    def build(loss_fn):
        net = GPT(cfg, device="cuda",
                  generator=torch.Generator().manual_seed(0))
        return TrainStep(net, loss_fn, optimizer.AdamW(
            1e-3, parameters=net.parameters()))

    def reads_back(out, lab):
        loss = F.cross_entropy(out, lab)
        loss.item()
        return loss

    step, error = build(reads_back), None
    try:
        got = step(ids, labels)
    except RuntimeError as e:
        error = str(e)
    else:
        raise AssertionError(f"capture_edges: a loss_fn that calls .item() "
                             f"returned {got}")
    if "capturing" not in error:
        raise AssertionError(f"capture_edges: the error does not name the "
                             f"capture: {error}")
    del step
    # after the failed capture, freed memory still returns to the card
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    scratch = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    del scratch
    torch.cuda.empty_cache()
    if torch.cuda.memory_reserved() > before:
        raise AssertionError(f"capture_edges: after the failed capture "
                             f"{torch.cuda.memory_reserved()} bytes stay "
                             f"reserved, {before} before a 1 GiB tensor")
    gen = torch.Generator(device="cuda")

    def dropped(out, lab):
        return F.cross_entropy(F.dropout(out, 0.1, generator=gen), lab)

    runs = []
    for captured in (False, True):
        torch.manual_seed(0)
        gen.manual_seed(1)
        step = build(dropped)
        fn = step if captured else step._step_uncaptured
        losses = torch.stack([fn(ids, labels) for _ in range(4)]).cpu()
        runs.append((losses, step_state(step), graph_summary(step),
                     gen.get_state(), torch.cuda.get_rng_state()))
        del step, fn
    (la, sa, _, ga, da), (lb, sb, gb, gbs, dbs) = runs
    differ = [k for k, v in sa.items() if not bits_equal(v, sb[k])]
    res = dict(item_error=error[:300], losses=lb.tolist(),
               losses_bit_for_bit=bits_equal(la, lb), state_differing=differ,
               generator_state_alike=torch.equal(ga, gbs),
               default_generator_state_alike=torch.equal(da, dbs),
               graphs=gb, card=card)
    log(f"capture_edges: .item() in loss_fn raised: {error[:160]!r}; remat "
        f"full + dropout 0.1 + an explicit generator's dropout, captured "
        f"vs uncaptured over 4 steps: losses bit for bit "
        f"{res['losses_bit_for_bit']}, {len(differ)} tensors differ, "
        f"generators' states alike {res['generator_state_alike']} / "
        f"{res['default_generator_state_alike']}; graphs {json.dumps(gb)}")
    if not (res["losses_bit_for_bit"] and not differ
            and res["generator_state_alike"]
            and res["default_generator_state_alike"]):
        raise AssertionError(f"capture_edges: {res}")
    return res


# --------------------------- phase 7: train-cpu ------------------------------


def train_cross_check(cfg):
    """One fp32 TrainStep (AdamW) at b1 s128 on the card and on the CPU
    (plain versions) from the same full-width weights, by
    `step_cross_check`."""
    from paddle_tpu_torch.models.gpt import GPT
    models = {"gpu": GPT(cfg, device="cuda",
                         generator=torch.Generator().manual_seed(1))}
    models["cpu"] = GPT(cfg, device="cpu")
    models["cpu"].load_state_dict({k: v.cpu() for k, v in
                                   models["gpu"].state_dict().items()})
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 128)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 128)))
    labels[0, :5] = -100  # ignore_index rows
    return step_cross_check("train-cpu", models,
                            lambda m, i, lb: m.loss(i, lb), ids, labels)


def step_cross_check(phase, models, loss_of, ids, labels, lr=1e-4,
                     floor=0.0, hold=True):
    """One fp32 TrainStep (AdamW) of models["gpu"] and models["cpu"] (the
    same weights) on the same batch, and the loss and every gradient of
    ``loss_of(model, ids, labels)`` before it (``ids`` a tensor or a tuple
    of the model's inputs, passed in order).

    Tolerances: the loss to 1e-4; each parameter's gradient to 2e-3 of its
    own largest magnitude, or of `floor` times the model's largest
    gradient where that is larger (fp32 sums in another order through 12
    layers and the output head, and the flash backward's dq atomics; a
    floor for leaves whose exact gradient is 0, such as a separate key
    bias: softmax ignores a shift shared by a row's scores); each
    parameter after the step to 2 * lr + 1e-6, since a first Adam step
    moves an element by lr * g / (|g| + eps), so a near-zero gradient that
    rounds to the other sign moves it by up to 2 * lr. A gradient that
    misses the layer-norm or attention branch, as when a kernel's output
    leaves the autograd graph, fails the gradient check by orders of
    magnitude. With hold=False a disagreement is returned (``held``
    False) instead of raised."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    res = {}
    for name, m in models.items():
        dev = next(m.parameters()).device
        i = tuple(t.to(dev) for t in (ids if isinstance(ids, tuple)
                                      else (ids,)))
        lb = labels.to(dev)
        params = dict(m.named_parameters())
        loss = loss_of(m, *i, lb)
        grads = torch.autograd.grad(loss, list(params.values()))
        opt = optimizer.AdamW(learning_rate=lr, parameters=m.parameters(),
                              weight_decay=0.01)
        step = TrainStep(m, F.cross_entropy, opt)
        step_loss = step(*i, lb)
        res[name] = dict(
            loss=float(loss.detach()), step_loss=float(step_loss),
            grads={k: g.detach().cpu() for k, g in zip(params, grads)},
            params={k: v.detach().cpu() for k, v in step.params.items()})
    g, c = res["gpu"], res["cpu"]
    loss_err = max(abs(g["loss"] - c["loss"]),
                   abs(g["step_loss"] - c["step_loss"]))
    top = max(float(v.abs().max()) for v in c["grads"].values())
    scale = {k: max(float(v.abs().max()), floor * top)
             for k, v in c["grads"].items()}
    ratios = {k: float((g["grads"][k] - c["grads"][k]).abs().max())
              / (2e-3 * scale[k] + 1e-12) for k in c["grads"]}
    grad_ratio = max(ratios.values())
    worst = sorted(ratios, key=ratios.get)[-3:][::-1]
    param_err = max(float((g["params"][k] - c["params"][k]).abs().max())
                    for k in c["params"])
    zero = [k for k, v in g["grads"].items() if not v.abs().max() > 0]
    log(f"{phase}: loss card {g['loss']:.6f} cpu {c['loss']:.6f} "
        f"(|diff| {loss_err:.3e}, atol 1e-4); gradients of "
        f"{len(c['grads'])} parameters: worst error / (2e-3 * scale) "
        f"{grad_ratio:.3e} ("
        + ", ".join(f"{k} {ratios[k]:.3e}, max |g| "
                    f"{float(c['grads'][k].abs().max()):.3e}"
                    for k in worst)
        + f"; top |g| {top:.3e})"
        + f"; parameters after one step: max |diff| "
        f"{param_err:.3e} (atol {2 * lr + 1e-6:g})")
    held = not zero and (loss_err <= 1e-4 and grad_ratio <= 1.0
                         and param_err <= 2 * lr + 1e-6)
    if hold and not held:
        raise AssertionError(f"{phase}: card and CPU disagree (zero "
                             f"gradients {zero})")
    return dict(loss=g["loss"], loss_cpu=c["loss"], loss_err=loss_err,
                grad_err_over_tol=grad_ratio,
                worst_grads={k: ratios[k] for k in worst},
                param_err=param_err, n_params=len(c["grads"]), held=held)


# ------------------------------ phase 8: resnet ------------------------------

RESNET_B, RESNET_HW = 128, 224
#: launches per training step of ResNet-50 (NHWC, fused BN, fused 1x1
#: conv + BN): the stem BN and 3 BNs in each of 16 bottlenecks take the
#: fused BN forward, reduce and dx; every stride-1 1x1 conv of the
#: bottlenecks (2 a block) the conv + statistics kernel; one loss. The
#: four downsample BNs are the unfused composition.
RESNET_PER_STEP = {"fused_bn_fwd": 49, "fused_bn_bwd_reduce": 49,
                   "fused_bn_bwd_dx": 49, "conv1x1_stats": 32,
                   "softmax_ce_fwd": 1, "softmax_ce_bwd": 1}
#: bench.py's model FLOPs of a ResNet-50 step per 224x224 image:
#: 3 * 4.09 GFLOP (forward plus a backward of twice the forward)
RESNET_FLOPS_PER_IMAGE = 3 * 4.09e9


def resnet_train(card, dev):
    """bench.py's bench_resnet50 configuration, NHWC without remat:
    ResNet-50 (fused BN, fused 1x1 conv + BN, 1000 classes) under
    TrainStep(F.cross_entropy, Momentum(0.1, 0.9), amp_dtype=bfloat16) at
    batch 128, 224x224, synthetic normal images and labels from seed 0."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    def build():
        net = resnet50(data_format="NHWC", device=dev,
                       generator=torch.Generator().manual_seed(0))
        return TrainStep(net, F.cross_entropy, optimizer.Momentum(
            learning_rate=0.1, momentum=0.9, parameters=net.parameters()),
            amp_dtype=torch.bfloat16)

    def batch(rng):
        return (torch.from_numpy(rng.normal(size=(
            RESNET_B, 3, RESNET_HW, RESNET_HW)).astype(np.float32)).permute(
                0, 2, 3, 1).contiguous().to(dev),
            torch.from_numpy(rng.integers(0, 1000, (RESNET_B,))).to(dev))

    step = build()
    model = step.layer
    rng = np.random.default_rng(0)
    imgs, labels = batch(rng)
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(imgs, labels)) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    kernels.reset_stats()
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(imgs, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    stats = kernels.all_stats()
    no_composed("resnet")
    ce_designs("resnet")
    per_step = {k: v["kernel"] / TRAIN_STEPS for k, v in stats.items()}
    # the step's 1x1 convs: the 12 shapes of RESNET_CONV_SHAPES, all on the
    # wgmma design
    conv_designs = kernels.design_stats().get("conv1x1_stats", {})
    conv_shapes = {k: v / TRAIN_STEPS for k, v in
                   kernels.shape_stats().get("conv1x1_stats", {}).items()}
    want_shapes = {conv_shape(*k): v for k, v in RESNET_CONV_SHAPES.items()}
    if conv_shapes != want_shapes or conv_designs != {
            "wgmma-tma": RESNET_PER_STEP["conv1x1_stats"] * TRAIN_STEPS}:
        raise AssertionError(f"resnet: 1x1 convs a step {conv_shapes} by "
                             f"design {conv_designs}; want {want_shapes}, "
                             f"all wgmma-tma")
    step_ms = float(np.median(times)) * 1e3
    flops = RESNET_FLOPS_PER_IMAGE * RESNET_B
    res = dict(batch=RESNET_B, hw=RESNET_HW, steps=TRAIN_STEPS,
               warmup=TRAIN_WARMUP, losses=losses, step_ms=step_ms,
               step_ms_all=[t * 1e3 for t in times],
               images_per_s=RESNET_B / (step_ms / 1e3), model_flops=flops,
               mfu=flops / (step_ms / 1e3) / BF16_PEAK, launches=stats,
               launches_per_step=per_step, conv1x1_shapes=conv_shapes,
               conv1x1_designs=conv_designs,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               card=card)
    log(f"resnet: ResNet-50 NHWC O2 bf16 b{RESNET_B} {RESNET_HW}x"
        f"{RESNET_HW}: step {step_ms:.2f} ms (median of {TRAIN_STEPS}), "
        f"{res['images_per_s']:.1f} images/s, MFU {res['mfu']:.4f} "
        f"(model FLOPs {flops:.4e} over {BF16_PEAK:.0e}), peak memory "
        f"{res['peak_mem_gb']:.2f} GB [{card}]")
    log(f"resnet: loss {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"resnet: launches per step {json.dumps(per_step)}")
    log(f"resnet: 1x1 conv launches a step by shape "
        f"{json.dumps(conv_shapes)}, by design {json.dumps(conv_designs)}")
    for name, st in stats.items():
        want = RESNET_PER_STEP.get(name, 0) * TRAIN_STEPS
        if st["plain"] != 0 or st["kernel"] != want:
            raise AssertionError(f"resnet: {name} counters {st}, want "
                                 f"{want // TRAIN_STEPS} kernel launches a "
                                 f"step and no plain run")
    # the first update must lower the loss. Momentum(0.1, 0.9) without
    # warm-up on one repeated batch then overshoots and the loss climbs
    # back: the JAX package does the same on the CPU at B 16, 64x64
    # (tests/test_torch_resnet.py::test_resnet50_momentum_steps_overshoot_
    # like_reference, where its loss peaks at 2.07 times its start), so
    # later steps are held only to stay finite and below 3 times the start
    if not (all(np.isfinite(losses)) and losses[1] < losses[0]
            and max(losses) < 3 * losses[0]):
        raise AssertionError(f"resnet: the loss did not fall after the "
                             f"first step, or left its bound: {losses}")
    res["graphs"] = graph_summary(step)
    res["capture"] = paired_capture("resnet", step, (imgs, labels),
                                    TRAIN_STEPS, card)
    step.release_graphs()
    del step, model
    torch.cuda.empty_cache()
    res["gate"] = capture_gate("resnet", build, [(imgs, labels), batch(rng)],
                               GATE_STEPS, RESNET_PER_STEP, twice=2)
    return res


def resnet_cross_check(dev, B, hw):
    """One fp32 TrainStep of ResNet-50 (NHWC, 10 classes, Momentum(0.1,
    0.9)) at batch B, hw x hw on the card and on the CPU (plain versions)
    from the same weights.

    The fp32 step of this randomly initialised network is ill-conditioned
    at every size tried (tests/test_torch_resnet.py::
    test_resnet50_step_parity_is_fp32_limited: the port's gradient moves
    1.5-2.7 % in relative L2 when the batch is only reordered, and most
    leaves by more than 2e-3 of their scale), so the bounds are those of
    tests/test_torch_resnet.py's whole-model case, which shows that the
    port's own rounding noise passes them and a 10 % error in one term of
    the fused BN backward fails them: the loss to 1e-3 of itself, the whole
    gradient to 10 % and each parameter's gradient to 15 % in relative L2,
    each parameter's update the same, and every running statistic to 1e-3
    of its buffer's scale. Each leaf's max |card - cpu| / max |cpu| is
    reported beside them."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.nn import functional as F
    lr = 0.1
    models = {"gpu": resnet50(num_classes=10, data_format="NHWC",
                              device=dev,
                              generator=torch.Generator().manual_seed(1))}
    models["cpu"] = resnet50(num_classes=10, data_format="NHWC",
                             device="cpu")
    models["cpu"].load_state_dict({k: v.cpu() for k, v in
                                   models["gpu"].state_dict().items()})
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(B, hw, hw, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, B))
    res = {}
    for name, m in models.items():
        dev = next(m.parameters()).device
        p0 = {k: v.detach().cpu().clone() for k, v in m.named_parameters()}
        step = TrainStep(m, F.cross_entropy, optimizer.Momentum(
            learning_rate=lr, momentum=0.9, parameters=m.parameters()))
        loss = step(x.to(dev), y.to(dev))
        res[name] = dict(
            loss=float(loss),
            grads={k: s["velocity"].detach().cpu()
                   for k, s in step.opt_state.items()},
            moved={k: p0[k] - v.detach().cpu()
                   for k, v in step.params.items()},
            buffers={k: v.detach().cpu() for k, v in step.buffers.items()})
    g, c = res["gpu"], res["cpu"]

    def rel_l2(a, b):
        return float((a - b).norm() / (b.norm() + 1e-30))

    loss_err = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    leaf = max(rel_l2(g["grads"][k], c["grads"][k]) for k in c["grads"])
    whole = (sum(float((g["grads"][k] - c["grads"][k]).norm()) ** 2
                 for k in c["grads"])
             / sum(float(c["grads"][k].norm()) ** 2 for k in c["grads"])
             ) ** 0.5
    per_leaf = [float((g["grads"][k] - v).abs().max())
                / (float(v.abs().max()) + 1e-30)
                for k, v in c["grads"].items()]
    moved = max(rel_l2(g["moved"][k], c["moved"][k]) for k in c["moved"])
    buf = max(float((g["buffers"][k] - v).abs().max())
              / (float(v.abs().max()) + 1e-30)
              for k, v in c["buffers"].items())
    zero = [k for k, v in g["grads"].items() if not v.abs().max() > 0]
    tag = f"resnet-cpu B {B} {hw}x{hw}"
    log(f"{tag}: loss card {g['loss']:.6f} cpu {c['loss']:.6f} (rel "
        f"{loss_err:.3e}, tol 1e-3); gradients of {len(c['grads'])} "
        f"parameters: whole rel L2 {whole:.3e} (tol 0.1), worst leaf "
        f"{leaf:.3e} (tol 0.15); update worst leaf {moved:.3e} (tol "
        f"0.15); {len(c['buffers'])} running statistics: worst "
        f"{buf:.3e} of scale (tol 1e-3)")
    log(f"{tag}: per leaf, max |card - cpu| / max |cpu|: worst "
        f"{max(per_leaf):.3e}, {sum(e > 2e-3 for e in per_leaf)} of "
        f"{len(per_leaf)} leaves past 2e-3 (reported, not held)")
    if zero or not (loss_err <= 1e-3 and whole <= 0.1 and leaf <= 0.15
                    and moved <= 0.15 and buf <= 1e-3):
        raise AssertionError(f"{tag}: card and CPU disagree (zero "
                             f"gradients {zero})")
    return dict(batch=B, hw=hw, loss=g["loss"], loss_cpu=c["loss"],
                loss_rel_err=loss_err, grad_rel_l2=whole,
                grad_rel_l2_worst_leaf=leaf,
                grad_max_err_over_scale_worst_leaf=max(per_leaf),
                leaves_past_2e3=sum(e > 2e-3 for e in per_leaf),
                update_rel_l2_worst_leaf=moved, buffer_err_over_scale=buf,
                n_params=len(c["grads"]), n_buffers=len(c["buffers"]))


# ------------------------------ phase 10: long ------------------------------

LONG_WARMUP, LONG_STEPS = 1, 2
#: launches per long-context step of GPT-2 small (12 layers) at remat
#: "full": the forward's two layer norms a block and the final one, and one
#: attention a block, then the backward's replay of every block (two layer
#: norms and one attention each); the split backward's dq and dk/dv once a
#: block; one loss. Every other kernel, the one-pass backward included,
#: launches no time.
LONG_PER_STEP = {"layer_norm": 25 + 24, "layer_norm_bwd": 25,
                 "flash_attention": 12 + 12,
                 "flash_attention_bwd_dq": 12, "flash_attention_bwd_dkv": 12,
                 "softmax_ce_fwd": 1, "softmax_ce_bwd": 1}


def long_config(layers=12, remat="full"):
    """GPT-2 small at full width on one 32,768-token sequence: the
    reference's training entry sets max_position_embeddings to the
    sequence length itself (bench.py:503-504); dropout 0."""
    from paddle_tpu_torch.models.gpt import GPTConfig
    cfg = GPTConfig.gpt2_small()
    cfg.max_position_embeddings = LONG_L
    cfg.num_layers = layers
    cfg.dropout = cfg.attn_dropout = 0.0
    cfg.remat = remat
    return cfg


def long_batch(cfg, dev):
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        1, LONG_L))).to(dev) for _ in range(2))


def long_train(card, dev):
    """GPT-2 small, remat "full", B 1 x 32,768, TrainStep(AdamW(1e-4, wd
    0.01), amp_dtype=bfloat16): one warm-up step, then timed steps; exact
    launches per step, no plain run, the first update lowers the loss."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    cfg = long_config()

    def build():
        net = GPT(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        return TrainStep(net, F.cross_entropy, optimizer.AdamW(
            learning_rate=1e-4, parameters=net.parameters(),
            weight_decay=0.01), amp_dtype=torch.bfloat16)

    step = build()
    model = step.layer
    ids, labels = long_batch(cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(ids, labels)) for _ in range(LONG_WARMUP)]
    torch.cuda.synchronize()
    kernels.reset_stats()
    times = []
    for _ in range(LONG_STEPS):
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    stats = kernels.all_stats()
    no_composed("long")
    ce_designs("long")
    per_step = {k: v["kernel"] / LONG_STEPS for k, v in stats.items()}
    step_ms = float(np.median(times)) * 1e3
    flops = model_flops(model, 1, LONG_L)
    res = dict(batch=1, seq=LONG_L, layers=cfg.num_layers, remat=cfg.remat,
               steps=LONG_STEPS, warmup=LONG_WARMUP, losses=losses,
               step_ms=step_ms, step_ms_all=[t * 1e3 for t in times],
               tokens_per_s=LONG_L / (step_ms / 1e3), model_flops=flops,
               mfu=flops / (step_ms / 1e3) / BF16_PEAK, launches=stats,
               launches_per_step=per_step,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               card=card)
    log(f"long: GPT-2 small O2 bf16 remat full b1 s{LONG_L}: step "
        f"{step_ms:.2f} ms (median of {LONG_STEPS}), "
        f"{res['tokens_per_s']:.1f} tokens/s, MFU {res['mfu']:.4f} (model "
        f"FLOPs {flops:.4e} over {BF16_PEAK:.0e}), peak memory "
        f"{res['peak_mem_gb']:.2f} GB [{card}]")
    log(f"long: loss {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"long: launches per step {json.dumps(per_step)}")
    for name, st in stats.items():
        want = LONG_PER_STEP.get(name, 0) * LONG_STEPS
        if st["plain"] != 0 or st["kernel"] != want:
            raise AssertionError(f"long: {name} counters {st}, want "
                                 f"{want // LONG_STEPS} kernel launches a "
                                 f"step and no plain run")
    if not (all(np.isfinite(losses)) and losses[1] < losses[0]):
        raise AssertionError(f"long: the first update did not lower the "
                             f"loss, or a loss is not finite: {losses}")
    res["graphs"] = graph_summary(step)
    res["capture"] = paired_capture("long", step, (ids, labels), LONG_STEPS,
                                    card)
    step.release_graphs()
    del step, model
    torch.cuda.empty_cache()
    res["gate"] = capture_gate("long", build, [(ids, labels)],
                               GATE_STEPS_LONG, LONG_PER_STEP)
    return res


#: a leaf that is not bit for bit the same across remat modes is held to
#: 2^-7 of its largest magnitude: one or two bf16 roundings of its
#: cotangent, where a sum taken in a varying order (atomics) rounds the
#: bf16 gradient to the neighbouring value
REMAT_REL = 2.0 ** -7


def remat_equivalence(dev):
    """A 2-layer GPT-2 small at full width and L 32,768, one O2 TrainStep
    (AdamW) at each remat mode from the same weights: the loss and every
    gradient against remat "" (bit for bit, or else within REMAT_REL,
    reported), and the peak memory of each mode ("full" must be below
    "")."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.nn import functional as F
    cfg = long_config(layers=2, remat="")
    model = GPT(cfg, device=dev, generator=torch.Generator().manual_seed(2))
    ids, labels = long_batch(cfg, dev)
    res = {}
    for mode in ("", "dots", "full"):
        model.cfg.remat = mode
        step = TrainStep(model, F.cross_entropy, optimizer.AdamW(
            learning_rate=1e-4, parameters=model.parameters(),
            weight_decay=0.01), amp_dtype=torch.bfloat16)
        grads = {}
        apply_fn = step.optimizer.apply_fn

        def record(p, g, state, **kw):
            if not grads:  # the real step; the capture after it runs nothing
                grads.update({k: v.clone() for k, v in g.items()})
            return apply_fn(p, g, state, **kw)

        step.optimizer.apply_fn = record
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = float(step(ids, labels))
        torch.cuda.synchronize()
        if step.stats["graph_captures"] != 1:
            raise AssertionError(f"remat {mode!r}: {step.stats}")
        res[mode] = dict(loss=loss, grads=grads, peak_gb=(
            torch.cuda.max_memory_allocated() - base) / 1e9)
        del step
        torch.cuda.empty_cache()
    ref = res[""]
    out = {}
    for mode in ("dots", "full"):
        r = res[mode]
        differ = [k for k, g in r["grads"].items()
                  if not torch.equal(g, ref["grads"][k])]
        worst = max([float((r["grads"][k] - ref["grads"][k]).abs().max())
                     / float(ref["grads"][k].abs().max()) for k in differ],
                    default=0.0)
        out[mode] = dict(loss=r["loss"], loss_equal=r["loss"] == ref["loss"],
                         leaves_not_bitwise=differ, worst_rel=worst,
                         peak_gb=r["peak_gb"])
        log(f"remat: {mode!r} vs '': loss {r['loss']:.6f} vs "
            f"{ref['loss']:.6f}; {len(r['grads']) - len(differ)} of "
            f"{len(r['grads'])} gradients bit for bit, the rest within "
            f"{worst:.3e} of scale (tol {REMAT_REL:.3e}): {differ}")
        if not (abs(r["loss"] - ref["loss"]) <= 1e-6 * abs(ref["loss"])
                and worst <= REMAT_REL):
            raise AssertionError(f"remat {mode!r} disagrees with no remat")
    out[""] = dict(loss=ref["loss"], peak_gb=ref["peak_gb"])
    log(f"remat: peak memory of the step above the resident state, 2 layers "
        f"at L {LONG_L}: " + ", ".join(f"{m!r} {out[m]['peak_gb']:.3f} GB"
                                   for m in ("", "dots", "full")))
    if not out["full"]["peak_gb"] < out[""]["peak_gb"]:
        raise AssertionError("remat: 'full' does not lower peak memory")
    del model
    torch.cuda.empty_cache()
    return out


def resnet_recompute_check(dev):
    """One ResNet-50 O2 step (NHWC, Momentum(0.1, 0.9)) at b128 224x224
    with recompute=True against the same step without it, from the same
    weights and batch: the loss to 1e-5 of itself and every running
    statistic to 1e-5 of its buffer's scale (both come from the forward,
    which is the same work; cuDNN may pick other algorithms between two
    models); every statistic moved from its start (once: a second move
    would take it 10 % further); every gradient, which the backward builds
    from the replayed stages, bit for bit or else within REMAT_REL of its
    leaf's scale (reported: cuDNN's weight-gradient sums may run in
    another order)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.normal(size=(
        RESNET_B, 3, RESNET_HW, RESNET_HW)).astype(np.float32)).permute(
            0, 2, 3, 1).contiguous().to(dev)
    labels = torch.from_numpy(rng.integers(0, 1000, (RESNET_B,))).to(dev)
    state = None
    res = {}
    for rc in (False, True):
        model = resnet50(data_format="NHWC", device=dev, recompute=rc,
                         generator=torch.Generator().manual_seed(0))
        if state is None:
            state = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(state)
        step = TrainStep(model, F.cross_entropy, optimizer.Momentum(
            learning_rate=0.1, momentum=0.9, parameters=model.parameters()),
            amp_dtype=torch.bfloat16)
        grads = {}
        apply_fn = step.optimizer.apply_fn

        def record(p, g, st, **kw):
            if not grads:  # the real step; the capture after it runs nothing
                grads.update({k: v.clone() for k, v in g.items()})
            return apply_fn(p, g, st, **kw)

        step.optimizer.apply_fn = record
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_stats()
        loss = float(step(imgs, labels))
        torch.cuda.synchronize()
        if step.stats["graph_captures"] != 1:
            raise AssertionError(f"resnet recompute={rc}: {step.stats}")
        res[rc] = dict(loss=loss, grads=grads,
                       buffers={k: v.clone() for k, v in
                                step.buffers.items()},
                       launches={k: v["kernel"] for k, v in
                                 kernels.all_stats().items() if v["kernel"]},
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del step, model
        torch.cuda.empty_cache()
    a, b = res[False], res[True]
    loss_rel = abs(b["loss"] - a["loss"]) / abs(a["loss"])
    buf = max(float((b["buffers"][k] - v).abs().max())
              / (float(v.abs().max()) + 1e-30)
              for k, v in a["buffers"].items())
    unmoved = [k for k, v in b["buffers"].items()
               if torch.equal(v, state[k].to(v.device))]
    if set(a["grads"]) != set(b["grads"]) or not a["grads"]:
        raise AssertionError("resnet-recompute: the two steps' gradients "
                             "name different leaves")
    differ = [k for k, g in b["grads"].items()
              if not torch.equal(g, a["grads"][k])]
    grad_rel = max([float((b["grads"][k] - a["grads"][k]).abs().max())
                    / (float(a["grads"][k].abs().max()) + 1e-30)
                    for k in differ], default=0.0)
    log(f"resnet-recompute: loss {b['loss']:.6f} vs {a['loss']:.6f} (rel "
        f"{loss_rel:.3e}, tol 1e-5); {len(b['grads']) - len(differ)} of "
        f"{len(b['grads'])} gradients bit for bit, the rest within "
        f"{grad_rel:.3e} of scale (tol {REMAT_REL:.3e}); running statistics "
        f"worst {buf:.3e} of scale (tol 1e-5), {len(unmoved)} unmoved; peak "
        f"memory {b['peak_gb']:.2f} GB vs {a['peak_gb']:.2f} GB; launches "
        f"{json.dumps(b['launches'])}")
    if unmoved or not (loss_rel <= 1e-5 and buf <= 1e-5
                       and grad_rel <= REMAT_REL):
        raise AssertionError(f"resnet-recompute: the step disagrees with "
                             f"no recompute (unmoved {unmoved}, gradients "
                             f"not bit for bit {differ})")
    return dict(loss=b["loss"], loss_no_recompute=a["loss"],
                loss_rel_err=loss_rel, buffer_err_over_scale=buf,
                grads_not_bitwise=differ, grad_err_over_scale=grad_rel,
                peak_gb=b["peak_gb"], peak_gb_no_recompute=a["peak_gb"],
                launches=b["launches"])


# ---------------------------- phase 13: composed -----------------------------

#: a composed route on the card against the same call on CPU copies of its
#: inputs (the plain versions and compositions the CPU takes), output and
#: gradients: fp32 1e-4 (TOL) and fp16 2^-9 (two fp16 roundings) of the
#: value's scale, max(1, max |ref|); both devices compute in fp32 and round
#: once to the input's type, summing in another order
COMPOSED_TOL = {torch.float32: 1e-4, torch.float16: 2.0 ** -9}

#: the kernel counters that each composed entry must leave at 0
COMPOSED_KERNELS = {
    "layer_norm": ("layer_norm", "layer_norm_bwd"),
    "flash_attention": ("flash_attention", "flash_attention_bwd",
                        "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                        "flash_attention_masked",
                        "flash_attention_bwd_masked",
                        "flash_attention_bwd_dq_masked",
                        "flash_attention_bwd_dkv_masked"),
    "softmax_ce": ("softmax_ce_fwd", "softmax_ce_bwd"),
    "fused_bn": ("fused_bn_fwd", "fused_bn_bwd_reduce", "fused_bn_bwd_dx")}


def composed_cases():
    """(case, entry, fn, inputs): calls that the reference sends to an XLA
    composition and the port, on a card, to its torch composition (ROADMAP
    queue C, C1-C3), with inputs from a numpy seed."""
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.default_rng(0)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    half = torch.float16
    B, L, H, D = 2, 128, 4, 64
    keep = torch.from_numpy(rng.random((B, 1, L, L)) > 0.3)

    def sdpa(q, k, v, mask=None, causal=False):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              is_causal=causal)

    def bn(x, g, b):
        C = x.shape[-1]
        return F.batch_norm(x, torch.zeros(C, device=x.device),
                            torch.ones(C, device=x.device), g, b,
                            training=True, data_format="NHWC", act="relu")

    return [
        ("fp16 layer norm R=64 N=768", "layer_norm",
         lambda x, g, b: F.layer_norm(x, 768, g, b),
         (t(64, 768, dtype=half), (1 + 0.1 * t(768)).to(half),
          (0.1 * t(768)).to(half))),
        (f"fp16 attention B={B} L={L} H={H} D={D} causal", "flash_attention",
         lambda q, k, v: sdpa(q, k, v, causal=True),
         tuple(t(B, L, H, D, dtype=half) for _ in range(3))),
        (f"float mask B={B} L={L} H={H} D={D}", "flash_attention", sdpa,
         (*(t(B, L, H, D) for _ in range(3)),
          torch.where(keep, 0.0, -1e9))),
        # 3-D: a bool mask the kernels' gate refuses (phase 3 and 21 run
        # the 4-D ones that broadcast on the masked kernels)
        (f"3-D bool mask [1, L, L] B={B} L={L} H={H} D={D} causal",
         "flash_attention",
         lambda q, k, v, m: sdpa(q, k, v, m, causal=True),
         (*(t(B, L, H, D) for _ in range(3)), keep[:1, 0])),
        (f"causal Lq={L} > Lk={L // 2}", "flash_attention",
         lambda q, k, v: sdpa(q, k, v, causal=True),
         (t(B, L, H, D), t(B, L // 2, H, D), t(B, L // 2, H, D))),
        (f"head dim 160 B={B} L={L} H={H}", "flash_attention",
         lambda q, k, v: sdpa(q, k, v, causal=True),
         tuple(t(B, L, H, 160) for _ in range(3))),
        ("fp16 cross entropy N=64 V=1000", "softmax_ce",
         lambda x, lab: F.cross_entropy(x, lab),
         (t(64, 1000, dtype=half),
          torch.from_numpy(rng.integers(0, 1000, 64)))),
        ("fp16 fused BN + ReLU N=8 8x8 C=64", "fused_bn", bn,
         (t(8, 8, 8, 64, dtype=half), 1 + 0.1 * t(64), 0.1 * t(64))),
    ]


def _fwd_bwd(fn, inputs, dev):
    """fn's output on `dev` and the gradients of <output, cotangent> for
    every floating input (the cotangent from a fixed seed)."""
    leaves = [x.to(dev).requires_grad_(x.is_floating_point())
              for x in inputs]
    out = fn(*leaves)
    cot = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tuple(out.shape)).astype(np.float32)).to(out.dtype).to(dev)
    grads = torch.autograd.grad(out, [x for x in leaves if x.requires_grad],
                                cot)
    return (out.detach(), *grads)


def check_composed(dev):
    """Every C1-C3 input on the card: it must run its entry's torch
    composition (the composed count moves by one) and none of the entry's
    kernels or plain versions, and agree with the same call on the CPU
    (COMPOSED_TOL), output and gradients."""
    from paddle_tpu_torch.ops import kernels
    res = []
    for case, entry, fn, inputs in composed_cases():
        kernels.reset_stats()
        got = _fwd_bwd(fn, inputs, dev)
        torch.cuda.synchronize()
        composed = kernels.composed_stats()
        launched = {k: v for k, v in kernels.all_stats().items()
                    if k in COMPOSED_KERNELS[entry]}
        ref = _fwd_bwd(fn, inputs, torch.device("cpu"))
        tol = COMPOSED_TOL[inputs[0].dtype]
        ratio = max(max_err(g.cpu(), r) / (tol * max(1.0, float(
            r.float().abs().max()))) for g, r in zip(got, ref))
        res.append(dict(case=case, entry=entry, composed=composed[entry],
                        kernel_counters=launched, tol_ratio=ratio))
        log(f"composed: {case:<40} {entry:<15} composed "
            f"{composed[entry]}, kernel counters "
            f"{json.dumps(launched)}; against the CPU /tol {ratio:.3f}")
        others = {k: v for k, v in composed.items() if k != entry and v}
        if (composed[entry] != 1 or others or ratio > 1.0
                or any(any(v.values()) for v in launched.values())):
            raise AssertionError(f"composed: {case} took the wrong route or "
                                 f"disagrees with the CPU: {res[-1]}, "
                                 f"other compositions {others}")
    return res


def no_composed(path):
    """Raise if a main path ran a torch composition in place of a kernel."""
    from paddle_tpu_torch.ops import kernels
    composed = kernels.composed_stats()
    if any(composed.values()):
        raise AssertionError(f"{path}: compositions ran on the main path: "
                             f"{composed}")


# ----------------------- phases 14-17: BERT, ERNIE, amp -----------------------

BERT_B, BERT_L = 256, 128
BERT_WARMUP, BERT_STEPS = 2, 6
#: launches per O2 step of the BERT-Base classifier: the embeddings' layer
#: norm and two a layer, one attention a layer, one loss
BERT_PER_STEP = {"layer_norm": 25, "layer_norm_bwd": 25,
                 "flash_attention": 12, "flash_attention_bwd": 12,
                 "softmax_ce_fwd": 1, "softmax_ce_bwd": 1}
#: ERNIE's MLM head adds a layer norm; its loss is over V 40,000
ERNIE_PER_STEP = dict(BERT_PER_STEP, layer_norm=26, layer_norm_bwd=26)
ERNIE_B, ERNIE_STEPS = 32, 2
AMP_B = 32
#: an O1 step's loss against the fp32 loss of the same weights on the card:
#: bf16 rounds activations to 8 significant bits, fp16 to 11 (the full-width
#: model on the CPU moves the loss of 0.84 by 1.5e-4 in either)
AMP_LOSS_TOL = {"bfloat16": 2e-2, "float16": 2e-3}


def bert_config():
    """bench.py's BERT-Base (bench_bert_base): 12 layers, hidden 768, 12
    heads, FFN 3072, vocab 30522, every dropout 0."""
    from paddle_tpu_torch.models.bert import BertConfig
    cfg = BertConfig.base()
    cfg.dropout = 0.0
    return cfg


def bert_classifier(cfg, device, seed):
    """bench.py's model: BERT and a Linear(hidden, 2) head on the pooled
    output, weights drawn from `seed`."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models.bert import Bert

    class BertCls(nn.Layer):
        def __init__(self):
            super().__init__(device)
            gen = torch.Generator().manual_seed(seed)
            self.cfg = cfg
            self.bert = Bert(cfg, device=device, generator=gen)
            self.head = nn.Linear(cfg.hidden_size, 2, device=device,
                                  generator=gen)
            self.name_parameters()

        def forward(self, ids):
            return self.head(self.bert(ids)[1])

    return BertCls()


def bert_batch(cfg, B, L, seed=0):
    """int32 ids and 0/1 labels from numpy seed `seed` (on the CPU)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    labels = rng.integers(0, 2, (B,)).astype(np.int32)
    return torch.from_numpy(ids), torch.from_numpy(labels)


def exact_launches(path, stats, per_step, steps):
    """Raise unless each kernel of `per_step` launched its count a step,
    no plain version ran and no other kernel launched; the CE's launches
    each on its predicted design (`ce_designs`)."""
    for name, st in stats.items():
        want = per_step.get(name, 0) * steps
        if st["plain"] != 0 or st["kernel"] != want:
            raise AssertionError(f"{path}: {name} counters {st}, want "
                                 f"{want} kernel launches and no plain run")
    if per_step.get("softmax_ce_fwd"):
        ce_designs(path)


def ce_designs(path):
    """Raise unless every CE launch since the last reset_stats reported
    the design the wrapper predicts for its shape (`fwd_design`,
    `bwd_design` of the V in the launch's `shape_stats` key), and at least one
    of each kernel ran; returns {kernel: {design: launches}}."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import softmax_ce as sce
    got = {}
    for name, twin in (("softmax_ce_fwd", sce.fwd_design),
                       ("softmax_ce_bwd", sce.bwd_design)):
        want = {}
        for shape, n in kernels.shape_stats().get(name, {}).items():
            d = twin(int(shape.split()[1][2:]))
            want[d] = want.get(d, 0) + n
        got[name] = kernels.design_stats().get(name, {})
        if not want or got[name] != want:
            raise AssertionError(f"{path}: {name} launched {got[name]} at "
                                 f"{kernels.shape_stats().get(name)}, the "
                                 f"wrapper predicts {want}")
    return got


def mma_attention(path, steps, layers=12, name="flash_attention"):
    """Raise unless every flash forward of the run (counted under `name`)
    reported "mma.sync"."""
    from paddle_tpu_torch.ops import kernels
    got = kernels.design_stats().get(name)
    if got != {"mma.sync": layers * steps}:
        raise AssertionError(f"{path}: flash forward designs {got}, want "
                             f"{layers * steps} on mma.sync")


def bert_train(card):
    """bench_bert_base: the BERT-Base classifier trained by
    jit.TrainStep(model, F.cross_entropy, AdamW(1e-4),
    amp_dtype=bfloat16) at B 256, L 128: warm-up steps, then timed steps on
    one batch; exact launches, every attention on mma.sync, no plain run
    or composition, the loss falls over the run."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    cfg = bert_config()

    def build():
        net = bert_classifier(cfg, "cuda", seed=0)
        return TrainStep(net, F.cross_entropy, optimizer.AdamW(
            learning_rate=1e-4, parameters=net.parameters()),
            amp_dtype=torch.bfloat16)

    step = build()
    model = step.layer
    ids, labels = (t.cuda() for t in bert_batch(cfg, BERT_B, BERT_L))
    losses = [float(step(ids, labels)) for _ in range(BERT_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_stats()
    times = []
    for _ in range(BERT_STEPS):
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    stats = kernels.all_stats()
    no_composed("bert")
    exact_launches("bert", stats, BERT_PER_STEP, BERT_STEPS)
    mma_attention("bert", BERT_STEPS)
    # AdamW's first step moves every weight by about lr, which at lr 1e-4
    # overshoots on this model: the loss rises, then falls below its start
    # within three more steps (BERT-Base on the CPU, B 8 and 32, fp32 and
    # O2; the reference's tiny BERT does the same), so the gate is the run
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"bert: the loss did not fall over the run, "
                             f"or a loss is not finite: {losses}")
    step_ms = float(np.median(times)) * 1e3
    flops = model_flops(model, BERT_B, BERT_L)
    res = dict(batch=BERT_B, seq=BERT_L, steps=BERT_STEPS,
               warmup=BERT_WARMUP, losses=losses, step_ms=step_ms,
               step_ms_all=[t * 1e3 for t in times],
               samples_per_s=BERT_B / (step_ms / 1e3),
               first_update_lowers_loss=losses[1] < losses[0],
               model_flops=flops, mfu=flops / (step_ms / 1e3) / BF16_PEAK,
               launches=stats,
               launches_per_step={k: v["kernel"] / BERT_STEPS
                                  for k, v in stats.items()},
               designs=kernels.design_stats(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               card=card)
    log(f"bert: BERT-Base O2 bf16 b{BERT_B} s{BERT_L}: step {step_ms:.2f} "
        f"ms (median of {BERT_STEPS}), {res['samples_per_s']:.1f} "
        f"samples/s, MFU {res['mfu']:.4f} (model FLOPs {flops:.4e} over "
        f"{BF16_PEAK:.0e}), peak {res['peak_mem_gb']:.2f} GB [{card}]")
    log(f"bert: loss {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"bert: launches per step {json.dumps(res['launches_per_step'])}")
    res["graphs"] = graph_summary(step)
    res["capture"] = paired_capture("bert", step, (ids, labels), BERT_STEPS,
                                    card)
    step.release_graphs()
    del step, model
    torch.cuda.empty_cache()
    other = tuple(t.cuda() for t in bert_batch(cfg, BERT_B, BERT_L, seed=1))
    res["gate"] = capture_gate("bert", build, [(ids, labels), other],
                               GATE_STEPS, BERT_PER_STEP)
    return res


def bert_cross_check():
    """The BERT-Base classifier in fp32 at B 2, L 128: one TrainStep on
    the card and on the CPU from the same weights (`step_cross_check`,
    with a floor of 1e-3 of the largest gradient for the key biases)."""
    from paddle_tpu_torch.nn import functional as F
    cfg = bert_config()
    models = {"gpu": bert_classifier(cfg, "cuda", seed=1),
              "cpu": bert_classifier(cfg, "cpu", seed=1)}
    ids, labels = bert_batch(cfg, 2, BERT_L, seed=1)
    res = step_cross_check("bert-cpu", models,
                           lambda m, i, lb: F.cross_entropy(m(i), lb),
                           ids, labels, floor=1e-3)
    del models
    torch.cuda.empty_cache()
    return res


def ernie_batch(cfg, B, L, seed=0):
    """Ids with knowledge-masked spans (1-4 tokens after gaps of 2-11,
    from numpy seed `seed`) and their labels, -100 outside the spans."""
    from paddle_tpu_torch.models.ernie import ernie_mask_tokens
    rng = np.random.default_rng(seed)
    raw = rng.integers(5, cfg.vocab_size, (B, L))
    spans = []
    for _ in range(B):
        row, pos = [], 0
        while True:
            pos += int(rng.integers(2, 12))
            end = pos + int(rng.integers(1, 5))
            if end > L:
                break
            row.append((pos, end))
            pos = end
        spans.append(row)
    ids, labels = ernie_mask_tokens(raw, spans, mask_token_id=3)
    return torch.from_numpy(ids), torch.from_numpy(labels)


def ernie_train(card):
    """ErnieForPretraining(ErnieConfig.base()) under O2 bf16 at B 32, L 128
    with knowledge-masked labels: the CE kernel at V 40,000 with
    ignore_index; two steps, exact launches, the loss finite and lower
    after the update."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.ernie import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    cfg = ErnieConfig.base()
    cfg.dropout = 0.0
    model = ErnieForPretraining(cfg, device="cuda",
                                generator=torch.Generator().manual_seed(4))
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = TrainStep(model, F.cross_entropy, opt, amp_dtype=torch.bfloat16)
    ids, labels = (t.cuda() for t in ernie_batch(cfg, ERNIE_B, BERT_L))
    kernels.reset_stats()
    losses = [float(step(ids, labels)) for _ in range(ERNIE_STEPS)]
    stats = kernels.all_stats()
    no_composed("ernie")
    exact_launches("ernie", stats, ERNIE_PER_STEP, ERNIE_STEPS)
    mma_attention("ernie", ERNIE_STEPS)
    masked = int((labels != -100).sum())
    log(f"ernie: ERNIE-3.0 Base O2 bf16 b{ERNIE_B} s{BERT_L}, {masked} of "
        f"{labels.numel()} tokens in masked spans, V {cfg.vocab_size}: "
        f"loss {' '.join(f'{x:.4f}' for x in losses)}; launches "
        f"{json.dumps({k: v['kernel'] for k, v in stats.items()})} [{card}]")
    if not all(np.isfinite(losses)) or not losses[1] < losses[0]:
        raise AssertionError(f"ernie: the loss did not fall: {losses}")
    del step, model, opt
    torch.cuda.empty_cache()
    return dict(batch=ERNIE_B, seq=BERT_L, masked_tokens=masked,
                vocab=cfg.vocab_size, losses=losses, launches=stats)


@contextlib.contextmanager
def launch_dtypes():
    """{kernel: {input type: calls}} of the flash forward, layer-norm and
    CE forward wrappers inside the block (their Functions look the
    wrappers up when they run)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    from paddle_tpu_torch.ops.kernels import softmax_ce as sce
    seen = {}
    saved = [(fa, "flash_attention_fwd"), (ln, "layer_norm_fwd"),
             (sce, "softmax_ce_fwd")]
    originals = [getattr(mod, fn) for mod, fn in saved]
    for (mod, fn), orig in zip(saved, originals):
        def wrapped(x, *a, _orig=orig, _key=fn, **kw):
            d = seen.setdefault(_key, {})
            d[str(x.dtype)[6:]] = d.get(str(x.dtype)[6:], 0) + 1
            return _orig(x, *a, **kw)
        setattr(mod, fn, wrapped)
    try:
        yield seen
    finally:
        for (mod, fn), orig in zip(saved, originals):
            setattr(mod, fn, orig)


def amp_eager_step(model, opt, scaler, ids, labels, dtype, inject=False):
    """The eager O1 loop's step: the loss under auto_cast, then
    scaler.scale(loss).backward(); scaler.step(opt); scaler.update(). With
    `inject`, one gradient element is set to inf before the step."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F
    with amp.auto_cast(level="O1", dtype=dtype):
        loss = F.cross_entropy(model(ids), labels)
    scaler.scale(loss).backward()
    if inject:
        model.head.weight.grad[0, 0] = float("inf")
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    return float(loss.detach())


#: what an O1 step's forward hands each kernel wrapper (the flash forward,
#: layer norm and CE): bf16 attention launches in bf16; fp16 attention
#: composes; layer norm and the CE get float32 (the black list)
AMP_FWD_DTYPES = {
    "bfloat16": {"flash_attention_fwd": {"bfloat16": 12},
                 "layer_norm_fwd": {"float32": 25},
                 "softmax_ce_fwd": {"float32": 1}},
    "float16": {"layer_norm_fwd": {"float32": 25},
                "softmax_ce_fwd": {"float32": 1}}}


def amp_scaler_run(cfg, state, device, ids, labels):
    """Three fp16 O1 steps with GradScaler(init_loss_scaling=1024,
    decr_every_n_nan_or_inf=1), an inf injected into the second one's
    gradient: [(loss, scale, skipped)] and the parameters after."""
    from paddle_tpu_torch import amp, optimizer
    model = bert_classifier(cfg, device, seed=2)
    model.load_state_dict({k: v.to(device) for k, v in state.items()})
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters())
    scaler = amp.GradScaler(init_loss_scaling=1024.0,
                            decr_every_n_nan_or_inf=1)
    seq = []
    for i in range(3):
        before = [p.detach().clone() for p in model.parameters()]
        loss = amp_eager_step(model, opt, scaler, ids.to(device),
                              labels.to(device), "float16", inject=i == 1)
        skipped = all(torch.equal(p, b)
                      for p, b in zip(model.parameters(), before))
        seq.append((loss, float(scaler.get_loss_scaling()), skipped))
    return seq, {k: v.detach().cpu() for k, v in model.named_parameters()}


def amp_check(card):
    """BERT-Base in the eager loop at B 32, L 128 under amp.auto_cast O1:
    one bf16 and one fp16 step from the same weights, each with its
    kernels' input types (AMP_FWD_DTYPES), launches and compositions
    checked and its loss held against the fp32 loss of those weights on
    the card (AMP_LOSS_TOL); then GradScaler's skip and back-off on an
    injected inf, on the card and on the CPU at B 2, L 16 (the same
    sequence; losses 2e-3, parameters 4 * lr + 1e-6: two Adam steps)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    cfg = bert_config()
    model = bert_classifier(cfg, "cuda", seed=2)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    ids, labels = (t.cuda() for t in bert_batch(cfg, AMP_B, BERT_L, seed=2))
    with torch.no_grad():
        loss32 = float(F.cross_entropy(model(ids), labels))
    res = dict(batch=AMP_B, seq=BERT_L, loss_fp32=loss32, card=card)
    for dtype in ("bfloat16", "float16"):
        model.load_state_dict({k: v.cuda() for k, v in state.items()})
        opt = optimizer.AdamW(learning_rate=1e-4,
                              parameters=model.parameters())
        scaler = amp.GradScaler(init_loss_scaling=1024.0)
        kernels.reset_stats()
        with launch_dtypes() as seen:
            loss = amp_eager_step(model, opt, scaler, ids, labels, dtype)
        torch.cuda.synchronize()
        stats = kernels.all_stats()
        composed = kernels.composed_stats()
        want_composed = {k: 0 for k in composed}
        per_step = dict(BERT_PER_STEP)
        if dtype == "float16":
            want_composed["flash_attention"] = 12
            per_step.pop("flash_attention")
            per_step.pop("flash_attention_bwd")
        err = abs(loss - loss32)
        res[dtype] = dict(loss=loss, loss_err=err, tol=AMP_LOSS_TOL[dtype],
                          fwd_dtypes=seen, composed=composed,
                          launches={k: v["kernel"] for k, v in
                                    stats.items()},
                          scale=float(scaler.get_loss_scaling()))
        log(f"amp: O1 {dtype} b{AMP_B} s{BERT_L}: loss {loss:.6f} against "
            f"fp32 {loss32:.6f} (|diff| {err:.3e}, tol "
            f"{AMP_LOSS_TOL[dtype]:g}); kernel inputs {json.dumps(seen)}; "
            f"compositions {json.dumps(composed)} [{card}]")
        exact_launches(f"amp {dtype}", stats, per_step, 1)
        if (seen != AMP_FWD_DTYPES[dtype] or composed != want_composed
                or not err <= AMP_LOSS_TOL[dtype]):
            raise AssertionError(f"amp {dtype}: {res[dtype]}")
        if dtype == "bfloat16":
            mma_attention("amp bfloat16", 1)
    del model
    torch.cuda.empty_cache()
    # B 2, L 16: fp16 products on a host CPU without fp16 units are slow
    # (the scaler's rule does not depend on the batch)
    runs = {dev: amp_scaler_run(cfg, state, dev, *bert_batch(
        cfg, 2, 16, seed=3)) for dev in ("cuda", "cpu")}
    (gseq, gp), (cseq, cp) = runs["cuda"], runs["cpu"]
    param_err = max(float((gp[k] - cp[k]).abs().max()) for k in cp)
    loss_err = max(abs(g[0] - c[0]) for g, c in zip(gseq, cseq))
    res["scaler"] = dict(card=gseq, cpu=cseq, param_err=param_err,
                         loss_err=loss_err)
    log(f"amp: fp16 GradScaler (loss, scale, skipped) card {gseq}, cpu "
        f"{cseq}; parameters max |diff| {param_err:.3e} (atol 4.01e-4)")
    if ([g[1:] for g in gseq] != [c[1:] for c in cseq]
            or [g[2] for g in gseq] != [False, True, False]
            or gseq[1][1] != gseq[0][1] / 2 or loss_err > 2e-3
            or param_err > 4 * 1e-4 + 1e-6):
        raise AssertionError(f"amp: GradScaler on the card and the CPU "
                             f"differ: {res['scaler']}")
    return res


# --------------------------------- main -------------------------------------


# --------------- phases 18-20: health sentinel, trip, fit + resume ---------------

HEALTH_WARMUP, HEALTH_STEPS, HEALTH_STEPS_10 = 2, 6, 20
#: off and on alternate run by run: the host's pace drifts over seconds
HEALTH_ROUNDS, HEALTH_ROUNDS_10 = 10, 6
#: the checkpoint directory of phase 20 (git-ignored; removed after)
CKPT_DIR = "ckpt_smoke"
FIT_STEPS = 8
#: resumed losses after the first, against the uninterrupted run (fp32,
#: loss near 10.9): only the order of dq's fp32 atomic sums differs
FIT_LOSS_ATOL = 1e-3


@contextlib.contextmanager
def env_var(name, value):
    """Set environment variable `name` to `value` (None: unset) inside."""
    prev = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def timed_steps(step, ids, labels, n):
    """(mean ms a step, losses) of a run of `n` steps, waited for once at
    its end: the host queues ahead of the card as a training loop does."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(ids, labels) for _ in range(n)]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, [float(x) for x in losses]


def device_ops(fn):
    """(device operations, device ms) of one call of `fn`, from
    torch.profiler's CUDA activity; (None, None) if it recorded none."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return None, None
    return len(evs), sum(e.time_range.elapsed_us() for e in evs) / 1e3


def free_card():
    """Collect what a phase left in reference cycles (hapi's Model and its
    callbacks hold each other, and so a TrainStep and its graphs' pool),
    then return the allocator's cached memory to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def rel(a, b):
    return abs(a - b) / abs(b)


def health_train(cfg, card):
    """Phase 18: the sentinel's cost and readings on the O2 bf16 GPT step
    (bench.py:527-533): health off and on (interval 1) in turns, then
    interval 10; returns the results and the on-step (phase 19 trips it)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    model = GPT(cfg, device="cuda", generator=torch.Generator().manual_seed(0))

    def make(on, interval=1):
        with env_var("PADDLE_TPU_HEALTH_INTERVAL", str(interval)):
            opt = optimizer.AdamW(learning_rate=1e-4,
                                  parameters=model.parameters(),
                                  weight_decay=0.01)
            return TrainStep(model, F.cross_entropy, opt,
                             amp_dtype=torch.bfloat16, health=on)

    rng = np.random.default_rng(0)
    ids, labels = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_L))).to("cuda") for _ in range(2))
    off, on, on10 = make(False), make(True), make(True, 10)
    # ms a step of each run (a run's mean), by variant, one run a round
    ms = {"off": [], "on": [], "off10": [], "on10": []}
    stats = None
    for rnd in range(HEALTH_ROUNDS):
        for name, st in (("off", off), ("on", on)):
            timed_steps(st, ids, labels, HEALTH_WARMUP)
            kernels.reset_stats()
            t, _ = timed_steps(st, ids, labels, HEALTH_STEPS)
            if name == "on" and rnd == 0:  # the health path's launches
                stats = kernels.all_stats()
                no_composed("health")
                exact_launches("health", stats, PER_STEP, HEALTH_STEPS)
            ms[name].append(t)
    for rnd in range(HEALTH_ROUNDS_10):
        for name, st in (("off10", off), ("on10", on10)):
            timed_steps(st, ids, labels, HEALTH_WARMUP)
            ms[name].append(timed_steps(st, ids, labels, HEALTH_STEPS_10)[0])
    if on10.last_health is None or on10.last_health["step"] % 10:
        raise AssertionError(f"health: interval 10 fetched at "
                             f"{on10.last_health}")

    def overhead(a, b):
        """The median of the rounds' overheads (each round pairs the two
        runs made back to back), and each round's."""
        per_round = [x / y - 1 for x, y in zip(ms[a], ms[b])]
        return float(np.median(per_round)), per_round

    frac1, rounds1 = overhead("on", "off")
    frac10, rounds10 = overhead("on10", "off10")

    # the sentinel's host time a step at interval 1, over one more run:
    # forming the vector; decoding one (its wait for the copy included,
    # at a step's start or inside the fetch); the fetch (the previous
    # vector's decode, then the copy)
    host = dict.fromkeys(("stats_vec", "flush_health", "fetch"), 0.0)

    def timed(key, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[key] += time.perf_counter() - t0
        return call

    # the calls' own host time a step, off and on (interval 1)
    call_ms = {}
    for name, st in (("off", off), ("on", on)):
        torch.cuda.synchronize()
        t = 0.0
        for _ in range(HEALTH_STEPS):
            t0 = time.perf_counter()
            st(ids, labels)
            t += time.perf_counter() - t0
        torch.cuda.synchronize()
        call_ms[name] = t * 1e3 / HEALTH_STEPS
    probe = on._health_probe
    probe.stats_vec = timed("stats_vec", probe.stats_vec)
    on.flush_health = timed("flush_health", on.flush_health)
    on._fetch = timed("fetch", on._fetch)
    try:
        timed_steps(on, ids, labels, HEALTH_STEPS)
    finally:
        del probe.stats_vec, on.flush_health, on._fetch
    host_ms = {k: v * 1e3 / HEALTH_STEPS for k, v in host.items()}

    # the readings against direct ones on one more step, uncaptured (the
    # same step function, whose gradients a spy on the update can read: a
    # replay calls no Python), then on a captured one (its loss and update
    # ratio against direct readings around it)
    seen = {}
    apply_fn = on.optimizer.apply_fn

    def spy(params, grads, state, **kw):
        seen["grad_norm"] = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads.values()])))
        return apply_fn(params, grads, state, **kw)

    def around(fn):
        old = {k: p.detach().clone() for k, p in on.params.items()}
        loss = float(fn(ids, labels))
        num = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(on.params[k].detach() - v)
             for k, v in old.items()]))
        den = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(v) for v in old.values()]))
        return loss, float(num / den), on.last_health

    on.optimizer.apply_fn = spy
    try:
        loss, ratio, h = around(on._step_uncaptured)
    finally:
        del on.optimizer.apply_fn
    loss_c, ratio_c, h_c = around(on)
    captured_ok = (h_c["loss"] == loss_c and not h_c["nonfinite"]
                   and rel(h_c["update_ratio"], ratio_c) <= 1e-5)
    values = [h["loss"], h["grad_norm"], h["param_norm"], h["update_ratio"],
              *h["group_grad_norms"].values()]
    errs = {"grad_norm": rel(h["grad_norm"], seen["grad_norm"]),
            "update_ratio": rel(h["update_ratio"], ratio)}
    if (h["loss"] != loss or max(errs.values()) > 1e-5 or h["nonfinite"]
            or not all(np.isfinite(values)) or not captured_ok):
        raise AssertionError(f"health: sentinel {h} against loss {loss}, "
                             f"grad norm {seen['grad_norm']}, update ratio "
                             f"{ratio}: relative errors {errs}; captured "
                             f"step's {h_c} against loss {loss_c}, update "
                             f"ratio {ratio_c}")
    # the sentinel's device operations: one fetched step against one
    # without it (the same kernels and update otherwise)
    n_on, dev_on = device_ops(lambda: on(ids, labels))
    n_off, dev_off = device_ops(lambda: off(ids, labels))
    sentinel_ops = None if n_on is None else n_on - n_off
    sentinel_dev_ms = None if n_on is None else dev_on - dev_off
    res = dict(batch=TRAIN_B, seq=TRAIN_L, warmup=HEALTH_WARMUP,
               steps=HEALTH_STEPS, steps_interval_10=HEALTH_STEPS_10,
               rounds=HEALTH_ROUNDS, rounds_interval_10=HEALTH_ROUNDS_10,
               step_ms=ms, step_ms_off=float(np.median(ms["off"])),
               step_ms_on=float(np.median(ms["on"])),
               overhead_frac=frac1, overhead_frac_rounds=rounds1,
               step_ms_off_10=float(np.median(ms["off10"])),
               step_ms_on_10=float(np.median(ms["on10"])),
               overhead_frac_10=frac10, overhead_frac_10_rounds=rounds10,
               groups=len(on._health_probe.group_names),
               group_names=on._health_probe.group_names,
               sentinel_host_ms=host_ms, call_host_ms=call_ms,
               graphs={"off": graph_summary(off), "on": graph_summary(on),
                       "on10": graph_summary(on10)},
               sentinel_device_ops=sentinel_ops,
               sentinel_device_ms=sentinel_dev_ms,
               step_device_ops=(n_on, n_off), step_device_ms=(dev_on, dev_off),
               reading=h, direct=dict(loss=loss, update_ratio=ratio,
                                      grad_norm=seen["grad_norm"]),
               reading_captured=h_c,
               direct_captured=dict(loss=loss_c, update_ratio=ratio_c),
               rel_err=errs, launches=stats, card=card)
    log(f"health: GPT-2 small O2 b{TRAIN_B} s{TRAIN_L}: step_ms_off "
        f"{res['step_ms_off']:.2f} step_ms_on {res['step_ms_on']:.2f} "
        f"(medians of {HEALTH_ROUNDS} runs of {HEALTH_STEPS}, one wait a "
        f"run) overhead_frac {frac1:+.4f} (median of the rounds) "
        f"(rounds {', '.join(f'{x:+.4f}' for x in rounds1)}); interval 10 "
        f"(medians of {HEALTH_ROUNDS_10} runs of {HEALTH_STEPS_10}) "
        f"{res['step_ms_off_10']:.2f} / {res['step_ms_on_10']:.2f} "
        f"overhead_frac {frac10:+.4f} "
        f"(rounds {', '.join(f'{x:+.4f}' for x in rounds10)}); host ms a "
        f"step {json.dumps({k: round(v, 4) for k, v in host_ms.items()})} "
        f"(a call's own host ms off / on {call_ms['off']:.4f} / "
        f"{call_ms['on']:.4f}); groups "
        f"{res['groups']}; sentinel device ops {sentinel_ops} "
        f"({sentinel_dev_ms if sentinel_dev_ms is None else round(sentinel_dev_ms, 4)} "
        f"ms; step {n_on} / {n_off} ops) [{card}]")
    log(f"health: step ms off {json.dumps(ms['off'])} on "
        f"{json.dumps(ms['on'])}")
    log(f"health: grad_norm {h['grad_norm']:.6e} (direct {seen['grad_norm']:.6e}) "
        f"update_ratio {h['update_ratio']:.6e} (direct {ratio:.6e}) "
        f"relative errors {json.dumps(errs)}; loss {h['loss']} == step's")
    del off, on10
    torch.cuda.empty_cache()
    return res, on, (ids, labels)


def health_trip(step, batch, card):
    """Phase 19: NaN in blocks.5's first layer-norm weight (the step's
    masters); one step trips the sentinel, names the group, and the replay
    names the layer-norm kernel's wrapper in blocks.5.ln1."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.profiler import health, metrics
    counter = metrics.default_registry().get("health_nonfinite_total")
    before = {src: counter.value(src=src) for src in ("sentinel", "eager")}
    with torch.no_grad():
        step.params["blocks.5.ln1.weight"].view(-1)[0] = float("nan")
    kernels.reset_stats()
    t0 = time.perf_counter()
    step(*batch)
    # reading them decodes the step's vector and runs the replay
    h, att = step.last_health, step.last_attribution
    torch.cuda.synchronize()
    trip_s = time.perf_counter() - t0
    st = kernels.all_stats()
    counts = {src: counter.value(src=src) - before[src] for src in before}
    # the step's own launches, then the replay's: embeddings, blocks 0-4
    # (two norms and one attention each), then blocks.5.ln1, which fails
    replay = {"layer_norm": 2 * 5 + 1, "flash_attention": 5}
    want = {k: PER_STEP.get(k, 0) + replay.get(k, 0) for k in st}
    ok = (h["nonfinite"] and h["bad_param_groups"] == ["blocks.5"]
          and att is not None and att["op"] == "layer_norm"
          and att["layer"] == "blocks.5.ln1"
          and all(v["plain"] == 0 and v["kernel"] == want[k]
                  for k, v in st.items())
          and counts == {"sentinel": 1, "eager": 1})
    res = dict(bad_param_groups=h["bad_param_groups"], attribution=att,
               launches=st, nonfinite_total=counts, seconds=trip_s, card=card)
    log(f"health_trip: nonfinite {h['nonfinite']} bad_param_groups "
        f"{h['bad_param_groups']} attribution {json.dumps(att)}; launches "
        f"in the step and its replay {json.dumps({k: v for k, v in st.items() if v['kernel']})}; "
        f"health_nonfinite_total +{json.dumps(counts)}; {trip_s:.2f} s [{card}]")
    if not ok:
        raise AssertionError(f"health_trip: {res}, want launches {want}")
    health.reset()
    return res


def fit_resume(cfg, card):
    """Phase 20: hapi.Model(GPT-2 small).fit in fp32 (as Model builds its
    TrainStep) at b8 s1024 with the sentinel on: an uninterrupted run; a
    run with FaultTolerantCheckpoint(save_freq_steps=2, keep_last_n=2) and
    HealthMonitor(rollback) that a callback poisons after step 5; then a
    fresh fit(resume=) past a truncated newest file."""
    import shutil
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi import callbacks as cb
    from paddle_tpu_torch.io import Dataset
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.profiler import events, health, metrics

    class Batches(Dataset):
        def __len__(self):
            return FIT_STEPS * TRAIN_B

        def __getitem__(self, i):
            rng = np.random.default_rng(100 + i)
            return (rng.integers(0, cfg.vocab_size, TRAIN_L),
                    rng.integers(0, cfg.vocab_size, TRAIN_L))

    class Record(cb.Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.ms = [], []

        def on_train_batch_begin(self, step, logs=None):
            self.t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.ms.append((time.perf_counter() - self.t0) * 1e3)
            self.losses.append(logs["loss"][0])

    class Poison(cb.Callback):
        def on_train_batch_end(self, step, logs=None):
            if step == 4:  # after the fifth step
                with torch.no_grad():
                    self.model._train_step.params[
                        "blocks.5.mlp.fc1.weight"].view(-1)[0] = float("nan")

    def model(seed):
        net = GPT(cfg, device="cuda",
                  generator=torch.Generator().manual_seed(seed))
        m = Model(net)
        m.prepare(optimizer.AdamW(1e-4, parameters=net.parameters(),
                                  weight_decay=0.01), F.cross_entropy)
        return m

    def fit(m, callbacks, **kw):
        m.fit(Batches(), batch_size=TRAIN_B, epochs=1, shuffle=False,
              verbose=0, callbacks=callbacks, **kw)

    reg = metrics.default_registry()
    d = os.path.abspath(CKPT_DIR)
    shutil.rmtree(d, ignore_errors=True)
    health.reset()
    try:
        with env_var("PADDLE_TPU_HEALTH", "1"):
            # run 0: uninterrupted
            rec0 = Record()
            m = model(0)
            kernels.reset_stats()
            fit(m, [rec0])
            stats = kernels.all_stats()
            designs = kernels.design_stats()
            no_composed("fit")
            exact_launches("fit", stats, PER_STEP, FIT_STEPS)
            # every fp32 one-pass backward on the TF32 tensor cores
            want = PER_STEP["flash_attention_bwd"] * FIT_STEPS
            if designs.get("flash_attention_bwd") != {
                    "mma.sync-3xtf32": want}:
                raise AssertionError(f"fit: one-pass backward designs "
                                     f"{designs}, want {want} on "
                                     f"mma.sync-3xtf32")
            del m
            free_card()
            # run 1: checkpoints, a poisoned weight, one rollback
            rec1 = Record()
            m = model(0)
            ftc = cb.FaultTolerantCheckpoint(d, save_freq_steps=2,
                                             keep_last_n=2)
            hm = cb.HealthMonitor(action="rollback", checkpoint=ftc)
            saves = []
            save = ftc.manager.save

            def timed_save(state, step):
                t0 = time.perf_counter()
                out = save(state, step)
                saves.append(dict(step=step,
                                  seconds=time.perf_counter() - t0,
                                  bytes=os.path.getsize(
                                      ftc.manager.path_for(step))))
                return out

            ftc.manager.save = timed_save
            rolled = reg.get("health_rollback_total").total()
            events.default_event_log().clear()
            fit(m, [ftc, hm, Poison(), rec1])
            rollbacks = events.recent(20, kind="health_rollback")
            rolled = reg.get("health_rollback_total").total() - rolled
            del m, ftc, hm
            free_card()
            files = ckpt.CheckpointManager(d).steps()
            # truncate the newest file; a fresh job resumes past it
            newest = os.path.join(d, f"ckpt_{files[0]}")
            with open(newest, "r+b") as f:
                f.truncate(os.path.getsize(newest) // 2)
            t0 = time.perf_counter()
            blob = ckpt.load(os.path.join(d, "ckpt_4"))
            load_s = time.perf_counter() - t0
            skipped = reg.get("checkpoint_corrupt_skipped_total").total()
            rec2 = Record()
            m = model(1)
            restored, restore_s = {}, []
            restore = m._restore_for_resume

            def timed_restore(*a, **kw):
                t0 = time.perf_counter()
                out = restore(*a, **kw)
                restore_s.append(time.perf_counter() - t0)
                net = {k: v.detach().cpu()
                       for k, v in m.network.state_dict().items()}
                restored["network"] = all(
                    torch.equal(net[k], v) for k, v in blob["network"].items()
                ) and net.keys() == blob["network"].keys()
                ts = m._pending_ts_state
                restored["train_step"] = ts["t"] == blob["train_step"]["t"] \
                    and all(torch.equal(torch.as_tensor(a), b) for a, b in zip(
                        ts["opt_flat"], blob["train_step"]["opt_flat"]))
                return out

            m._restore_for_resume = timed_restore
            fit(m, [rec2], resume=d)
            skipped = reg.get("checkpoint_corrupt_skipped_total").total() \
                - skipped
            del m
            free_card()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    l0, l1, l2 = rec0.losses, rec1.losses, rec2.losses
    later = [abs(a - b) for a, b in zip(l2[1:], l0[5:])]
    step_ms = float(np.median(rec0.ms[1:]))
    res = dict(batch=TRAIN_B, seq=TRAIN_L, steps=FIT_STEPS,
               losses=dict(uninterrupted=l0, rollback=l1, resumed=l2),
               step_ms_fp32=step_ms, step_ms_all=rec0.ms,
               saves=saves, load_seconds=load_s,
               restore_seconds=restore_s[0] if restore_s else None,
               files_after_rollback_run=files, rollback_events=rollbacks,
               health_rollback_total=rolled,
               checkpoint_corrupt_skipped_total=skipped, restored=restored,
               later_loss_abs_diff=later, loss_atol=FIT_LOSS_ATOL,
               launches=stats, designs=designs, card=card)
    log(f"fit_resume: Model.fit GPT-2 small fp32 b{TRAIN_B} s{TRAIN_L}: "
        f"step {step_ms:.2f} ms (median of {FIT_STEPS - 1}); saves "
        + ", ".join(f"step {s['step']} {s['seconds']:.3f} s {s['bytes']} B"
                    for s in saves)
        + f"; load {load_s:.3f} s; resume restore "
        f"{res['restore_seconds']:.3f} s (past the truncated file) [{card}]")
    log(f"fit_resume: losses uninterrupted {json.dumps(l0)}; rollback run "
        f"{json.dumps(l1)}; resumed {json.dumps(l2)}; later |diff| "
        f"{json.dumps(later)} (atol {FIT_LOSS_ATOL}); rollbacks "
        f"{json.dumps(rollbacks)}; flash designs {json.dumps(designs)}")
    ok = (len(rollbacks) == 1 and rollbacks[0]["restored_step"] == 4
          and rolled == 1 and files == [8, 4] and skipped == 1
          and restored == {"network": True, "train_step": True}
          and len(l0) == FIT_STEPS and all(np.isfinite(l0))
          and l1[0] == l0[0] and np.isnan(l1[5]) and len(l2) == 4
          and all(np.isfinite(l2)) and l2[0] == l1[4]
          and max(later) <= FIT_LOSS_ATOL)
    if not ok:
        raise AssertionError(f"fit_resume: {res}")
    return res


# --------------- phase 21: Transformer-base on padded batches ---------------

#: Vaswani et al. 2017's shared En-De BPE vocabulary (section 5.1)
TB_VOCAB = 37000
#: the type of the logits the O2 step hands the CE (held in phase 21)
TB_CE_DTYPE = torch.bfloat16
TB_WARMUP, TB_STEPS = 2, 8
#: launches per O2 step of Transformer-base (6 + 6 layers, post-norm):
#: the encoder's self-attention, the decoder's self- and cross-attention,
#: all with bool masks; two layer norms an encoder layer, three a decoder
#: layer; one loss over the padded targets
TB_PER_STEP = {"layer_norm": 30, "layer_norm_bwd": 30,
               "flash_attention_masked": 18,
               "flash_attention_bwd_masked": 18, "softmax_ce_fwd": 1,
               "softmax_ce_bwd": 1}


def sinusoid_table(L, d):
    """Vaswani et al.'s fixed positions (section 3.5): sin on even dims,
    cos on odd, [L, d] fp32."""
    pos = np.arange(L)[:, None]
    ang = pos / np.power(10000.0, 2 * np.arange(d // 2)[None, :] / d)
    table = np.zeros((L, d), np.float32)
    table[:, 0::2] = np.sin(ang)
    table[:, 1::2] = np.cos(ang)
    return table


def transformer_base(device, seed, dropout=0.1, layers=6, vocab=TB_VOCAB,
                     max_len=TB_LS):
    """Transformer-base for translation around nn.Transformer() at the
    reference's defaults (d_model 512, 8 heads, FFN 2048, ReLU,
    post-norm): one embedding shared by source, target and output
    (section 3.4), scaled by sqrt(d_model), plus fixed sinusoidal
    positions, with dropout on the sum; the logits are the decoder's
    output times the embedding's transpose. Residual and FFN dropout
    `dropout`, attention dropout 0; weights drawn from `seed`. The test's
    twin (tests/test_torch_masked_attention.py) builds the same model in
    both packages."""
    from paddle_tpu_torch import nn

    class TransformerBase(nn.Layer):
        def __init__(self):
            super().__init__(device)
            gen = torch.Generator().manual_seed(seed)
            self.d_model = 512
            self.embedding = nn.Embedding(vocab, 512, device=device,
                                          generator=gen)
            self.transformer = nn.Transformer(
                num_encoder_layers=layers, num_decoder_layers=layers,
                dropout=dropout, attn_dropout=0.0, device=device,
                generator=gen)
            self.dropout = nn.Dropout(dropout)
            self._position = torch.from_numpy(sinusoid_table(
                max_len, 512)).to(self._device)
            self.name_parameters()

        def _embed(self, ids):
            x = self.embedding(ids) * math.sqrt(self.d_model)
            return self.dropout(
                x + self._position[:ids.shape[1]].to(x.dtype))

        def forward(self, src, tgt, src_mask, tgt_mask, memory_mask):
            h = self.transformer(self._embed(src), self._embed(tgt),
                                 src_mask, tgt_mask, memory_mask)
            return torch.matmul(h, self.embedding.weight.t())

    return TransformerBase()


def tb_batch(B, Ls, Lt, seed=0, vocab=TB_VOCAB):
    """A bucketed batch from numpy seed `seed`, on the CPU: (src, tgt_in,
    src_mask, tgt_mask, memory_mask, labels). Source rows of 64..Ls and
    target rows of 56..Lt real tokens (half to full), random ids, pad id
    0; tgt_in is the target shifted right behind a BOS of 1; labels are
    -100 past each target. Masks from `padding_masks`."""
    rng = np.random.default_rng(seed)
    src_len = rng.integers(Ls // 2, Ls + 1, B)
    tgt_len = rng.integers(Lt // 2, Lt + 1, B)
    src = rng.integers(2, vocab, (B, Ls))
    tgt = rng.integers(2, vocab, (B, Lt))
    src[np.arange(Ls)[None, :] >= src_len[:, None]] = 0
    past = np.arange(Lt)[None, :] >= tgt_len[:, None]
    tgt_in = np.concatenate([np.ones((B, 1), np.int64), tgt[:, :-1]], 1)
    tgt_in[past] = 0
    labels = np.where(past, -100, tgt)
    masks = padding_masks(torch.from_numpy(src_len),
                          torch.from_numpy(tgt_len), Ls, Lt)
    return (torch.from_numpy(src), torch.from_numpy(tgt_in), *masks,
            torch.from_numpy(labels))


def tb_flops(model, B, Ls, Lt):
    """Model FLOPs of one step, bench.py's way (6 per parameter and token
    it sees, plus 12 * d_model per attended (q, k) pair and layer): the
    encoder's parameters see B * Ls tokens, the decoder's and the tied
    output projection B * Lt (the embedding lookup is free); attention
    counts all Ls^2, Lt^2 and Lt * Ls pairs of the padded batch, as the
    kernels walk them."""
    enc = sum(p.numel() for p in model.transformer.encoder.parameters())
    dec = sum(p.numel() for p in model.transformer.decoder.parameters())
    out = model.embedding.weight.numel()
    layers = len(model.transformer.encoder.layers)
    pairs = B * (Ls * Ls + Lt * Lt + Lt * Ls)
    return (6 * (enc * B * Ls + (dec + out) * B * Lt)
            + 12 * model.d_model * layers * pairs)


def transformer_train(card):
    """Transformer-base (Vaswani et al. 2017, Table 3) trained on padded
    batches by jit.TrainStep(model, F.cross_entropy, Adam(0.9, 0.98,
    1e-9) over NoamDecay(512, warmup 4000), amp_dtype=bfloat16) at B 32,
    sources padded to 128 and targets to 112, residual dropout 0.1,
    attention dropout 0: warm-up steps, then timed steps on one batch,
    the scheduler stepped after each. Every attention takes its bool mask
    to the masked kernels (exact launches, mma.sync, no plain run or
    composition); the loss must fall over the run; step ms, tokens/s
    (padded and real), MFU and peak memory."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    def build():
        net = transformer_base("cuda", seed=0)
        return TrainStep(net, F.cross_entropy, optimizer.Adam(
            learning_rate=optimizer.lr.NoamDecay(d_model=512,
                                                 warmup_steps=4000),
            beta1=0.9, beta2=0.98, epsilon=1e-9,
            parameters=net.parameters()), amp_dtype=torch.bfloat16)

    def sched_step(st):
        st.optimizer._learning_rate.step()

    torch.manual_seed(0)  # dropout's stream
    before = torch.cuda.memory_allocated()
    step = build()
    model, sched = step.layer, step.optimizer._learning_rate
    batch = [t.cuda() for t in tb_batch(TB_B, TB_LS, TB_LT)]
    losses = []
    with launch_dtypes() as seen:
        for _ in range(TB_WARMUP):
            losses.append(float(step(*batch)))
            sched.step()
    # phase 3's CE row at this step's shape runs in the type the step
    # hands the CE (the wrapper runs at a signature's first use only: a
    # replay calls no Python)
    if set(seen.get("softmax_ce_fwd", ())) != {str(TB_CE_DTYPE)[6:]}:
        raise AssertionError(f"transformer: the CE took {seen}, phase 3 "
                             f"checks it in {TB_CE_DTYPE}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_stats()
    times = []
    for _ in range(TB_STEPS):
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        sched.step()
    stats = kernels.all_stats()
    no_composed("transformer")
    exact_launches("transformer", stats, TB_PER_STEP, TB_STEPS)
    mma_attention("transformer", TB_STEPS, layers=18,
                  name="flash_attention_masked")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"transformer: the loss did not fall over the "
                             f"run, or a loss is not finite: {losses}")
    step_ms = float(np.median(times)) * 1e3
    flops = tb_flops(model, TB_B, TB_LS, TB_LT)
    real = int(batch[2].sum()) + int((batch[-1] != -100).sum())
    padded = TB_B * (TB_LS + TB_LT)
    res = dict(batch=TB_B, src_len=TB_LS, tgt_len=TB_LT, steps=TB_STEPS,
               warmup=TB_WARMUP, losses=losses, lr_last=sched.get_lr(),
               step_ms=step_ms, step_ms_all=[t * 1e3 for t in times],
               tokens_per_s=padded / (step_ms / 1e3),
               real_tokens=real, real_tokens_per_s=real / (step_ms / 1e3),
               model_flops=flops, mfu=flops / (step_ms / 1e3) / BF16_PEAK,
               launches=stats,
               launches_per_step={k: v["kernel"] / TB_STEPS
                                  for k, v in stats.items()},
               designs=kernels.design_stats(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_mem_own_gb=(torch.cuda.max_memory_allocated()
                                - before) / 1e9,
               card=card)
    log(f"transformer: Transformer-base O2 bf16 b{TB_B} src {TB_LS} tgt "
        f"{TB_LT}, bool masks: step {step_ms:.2f} ms (median of "
        f"{TB_STEPS}), {res['tokens_per_s']:.1f} tokens/s padded, "
        f"{res['real_tokens_per_s']:.1f} real ({real} a step), MFU "
        f"{res['mfu']:.4f} (model FLOPs {flops:.4e} over {BF16_PEAK:.0e}), "
        f"peak {res['peak_mem_gb']:.2f} GB ({res['peak_mem_own_gb']:.2f} "
        f"above what was allocated before the model) [{card}]")
    log(f"transformer: loss {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"transformer: launches per step "
        f"{json.dumps(res['launches_per_step'])}")
    res["graphs"] = graph_summary(step)
    res["capture"] = paired_capture("transformer", step, batch, TB_STEPS,
                                    card, after_step=sched_step)
    step.release_graphs()
    del step, model, sched
    torch.cuda.empty_cache()
    other = [t.cuda() for t in tb_batch(TB_B, TB_LS, TB_LT, seed=1)]
    res["gate"] = capture_gate("transformer", build, [batch, other],
                               GATE_STEPS, TB_PER_STEP, after_step=sched_step)
    return res


def match_relu(models, inputs):
    """Hooks that give the CPU model's FFN first layers the card's
    pre-activation wherever the two devices round one to opposite sides
    of ReLU's 0, so that both differentiate the same piece of the
    piecewise-linear function. Without them one such flip puts a token's
    whole term into the gradient of the FFN before the ReLU on one device
    and not on the other, and its difference flows back through every
    earlier layer: a difference of the function at a point within
    rounding of its kink, not of the kernels. The value moves by the
    devices' rounding difference and the gradient still flows through it.
    Returns (the hooks, {layer: flips in the CPU's latest forward})."""
    card, flips = {}, {}
    names = [n for n, _ in models["cpu"].named_modules()
             if n.endswith("linear1")]
    hooks = [models["gpu"].get_submodule(n).register_forward_hook(
        lambda mod, a, out, n=n: card.__setitem__(n, out.detach().cpu()))
        for n in names]
    dev = next(models["gpu"].parameters()).device
    with torch.no_grad():
        models["gpu"](*(t.to(dev) for t in inputs))
    for h in hooks:
        h.remove()

    def snap(mod, a, out, n):
        flip = (out > 0) != (card[n] > 0)
        flips[n] = int(flip.sum())
        return out + torch.where(flip, card[n] - out, 0.0).detach()

    return [models["cpu"].get_submodule(n).register_forward_hook(
        functools.partial(snap, n=n)) for n in names], flips


def transformer_cross_check(seed=1, hold=True):
    """Transformer-base in fp32 with every dropout 0 at B 2 (sources 128,
    targets 112, bool masks): one TrainStep on the card and on the CPU
    from the same weights (`step_cross_check`, with phase 15's floor of
    1e-3 of the largest gradient for the key biases, whose exact gradient
    is 0), the CPU's ReLU branches matched to the card's (`match_relu`;
    the flips are counted). tools/tb_grad_check.py runs it at more seeds
    and against kernels broken on purpose."""
    from paddle_tpu_torch.nn import functional as F
    models = {"gpu": transformer_base("cuda", seed=seed, dropout=0.0),
              "cpu": transformer_base("cpu", seed=seed, dropout=0.0)}
    *inputs, labels = tb_batch(2, TB_LS, TB_LT, seed=seed)
    hooks, flips = match_relu(models, inputs)
    try:
        res = step_cross_check(
            f"transformer-cpu seed {seed}", models,
            lambda m, *a: F.cross_entropy(m(*a[:-1]), a[-1]),
            tuple(inputs), labels, floor=1e-3, hold=hold)
    finally:
        for h in hooks:
            h.remove()
    log(f"transformer-cpu seed {seed}: ReLU branches matched to the card's "
        f"at {sum(flips.values())} pre-activations {json.dumps(flips)}")
    del models
    torch.cuda.empty_cache()
    return dict(res, seed=seed, relu_flips=sum(flips.values()))


# ------------------------- phase 22: resnet_fit (fp32) -------------------------

RESNET_FIT_WARMUP, RESNET_FIT_STEPS = 2, 8


@contextlib.contextmanager
def default_tf32_flags():
    """PyTorch's default TF32 flags inside, as a user's process has them
    (fp32 matrix products in full fp32, cuDNN's fp32 convolutions allowed
    TF32); this script's own (both off) come back after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def check_conv2d_fp32(dev):
    """The port's fp32 F.conv2d under PyTorch's default flags (cuDNN's
    allow_tf32 True) against the same call with the flag off, forward and
    the input and weight gradients, bit for bit (cuDNN deterministic in
    both), at ResNet-50's stem (7x7 stride 2, 3 -> 64, B 8 224x224) and a
    layer1 3x3 (64 -> 64, B 8 56x56), NHWC: the call runs in full fp32
    whatever the global flag. torch's own conv2d under the default flags
    is reported beside it (its distance is what one TF32 pass changes)."""
    from paddle_tpu_torch.nn import functional as F
    tF = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, (B, H, Cin, Cout, k, stride, pad) in {
                "stem 7x7/2": (8, 224, 3, 64, 7, 2, 3),
                "layer1 3x3": (8, 56, 64, 64, 3, 1, 1)}.items():
            x = torch.randn(B, H, H, Cin, device=dev, generator=gen)
            w = torch.randn(Cout, Cin, k, k, device=dev,
                            generator=gen) / (Cin * k * k) ** 0.5
            dy = None
            res = {}
            for flag in (True, False):
                torch.backends.cudnn.allow_tf32 = flag
                xi = x.clone().requires_grad_(True)
                wi = w.clone().requires_grad_(True)
                y = F.conv2d(xi, wi, None, stride, pad, 1, 1, "NHWC")
                if dy is None:
                    dy = torch.randn(y.shape, device=dev, generator=gen)
                gx, gw = torch.autograd.grad(y, (xi, wi), dy)
                res[flag] = (y.detach(), gx, gw)
            torch.backends.cudnn.allow_tf32 = True
            raw = tF.conv2d(x.permute(0, 3, 1, 2), w, None, stride,
                            pad).permute(0, 2, 3, 1)
            ref = res[False][0]
            raw_rel = float((raw - ref).abs().max() / ref.abs().max())
            same = all(torch.equal(a, b) for a, b in zip(res[True],
                                                         res[False]))
            out[name] = dict(bit_for_bit=same, torch_default_rel=raw_rel)
            log(f"resnet_fit: F.conv2d fp32 {name} under the default flags "
                f"against allow_tf32=False: forward, dx, dw bit for bit "
                f"{same}; torch's conv2d under the default flags differs "
                f"by {raw_rel:.3e} of max |y| (reported)")
            if not same:
                raise AssertionError(f"resnet_fit: the port's fp32 conv2d "
                                     f"{name} depends on cuDNN's TF32 flag")
    finally:
        torch.backends.cudnn.deterministic = prev_det
    return out


def resnet_fit(card):
    """Phase 22: ResNet-50 (NHWC, 1000 classes, random weights from seed
    0) trained in fp32 through hapi.Model(net).prepare(Momentum(0.1, 0.9),
    F.cross_entropy).fit(...), as Model builds its TrainStep (no amp
    type), at bench_resnet50's B 128, 224x224, on one seeded batch
    repeated, under PyTorch's default TF32 flags: 2 warm-up and 8 timed
    steps. Exact launches a step (RESNET_PER_STEP), every 1x1 conv at the
    12 shapes of RESNET_CONV_SHAPES on the "wgmma-3xtf32" design, no plain
    run or composition; the first update lowers the loss and every loss
    stays finite and below 3 times the first (phase 8's rule); step ms
    (one train_batch: the batch's copy to the card and the loss's fetch
    included), images/s, MFU (phase 8's convention), peak memory (and
    above what earlier phases left allocated). Before it,
    check_conv2d_fp32."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi import callbacks as cb
    from paddle_tpu_torch.io import Dataset
    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    n_steps = RESNET_FIT_WARMUP + RESNET_FIT_STEPS
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((RESNET_B, RESNET_HW, RESNET_HW, 3),
                               dtype=np.float32)
    labels = rng.integers(0, 1000, RESNET_B)

    class Batch(Dataset):
        def __len__(self):
            return n_steps * RESNET_B

        def __getitem__(self, i):
            return imgs[i % RESNET_B], labels[i % RESNET_B]

    class Record(cb.Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.ms = [], []

        def on_train_batch_begin(self, step, logs=None):
            if step == RESNET_FIT_WARMUP:  # counts from the timed steps
                torch.cuda.synchronize()
                kernels.reset_stats()
            self.t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.ms.append((time.perf_counter() - self.t0) * 1e3)
            self.losses.append(logs["loss"][0])

    with default_tf32_flags():
        conv2d = check_conv2d_fp32(torch.device("cuda"))
        net = resnet50(data_format="NHWC", device="cuda",
                       generator=torch.Generator().manual_seed(0))
        m = Model(net)
        m.prepare(optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=net.parameters()),
                  F.cross_entropy)
        rec = Record()
        torch.cuda.reset_peak_memory_stats()
        start_mem = torch.cuda.memory_allocated()
        m.fit(Batch(), batch_size=RESNET_B, epochs=1, shuffle=False,
              verbose=0, callbacks=[rec])
        torch.cuda.synchronize()
    stats = kernels.all_stats()
    no_composed("resnet_fit")
    exact_launches("resnet_fit", stats, RESNET_PER_STEP, RESNET_FIT_STEPS)
    conv_designs = kernels.design_stats().get("conv1x1_stats", {})
    conv_shapes = {k: v / RESNET_FIT_STEPS for k, v in
                   kernels.shape_stats().get("conv1x1_stats", {}).items()}
    want_shapes = {conv_shape(*k): v for k, v in RESNET_CONV_SHAPES.items()}
    want_n = RESNET_PER_STEP["conv1x1_stats"] * RESNET_FIT_STEPS
    if conv_shapes != want_shapes or conv_designs != {"wgmma-3xtf32":
                                                      want_n}:
        raise AssertionError(f"resnet_fit: 1x1 convs a step {conv_shapes} "
                             f"by design {conv_designs}; want {want_shapes},"
                             f" all wgmma-3xtf32")
    losses = rec.losses
    times = rec.ms[RESNET_FIT_WARMUP:]
    step_ms = float(np.median(times))
    flops = RESNET_FLOPS_PER_IMAGE * RESNET_B
    res = dict(batch=RESNET_B, hw=RESNET_HW, steps=RESNET_FIT_STEPS,
               warmup=RESNET_FIT_WARMUP, dtype="float32", losses=losses,
               step_ms=step_ms, step_ms_all=times,
               images_per_s=RESNET_B / (step_ms / 1e3), model_flops=flops,
               mfu=flops / (step_ms / 1e3) / BF16_PEAK, launches=stats,
               launches_per_step={k: v["kernel"] / RESNET_FIT_STEPS
                                  for k, v in stats.items()},
               conv1x1_shapes=conv_shapes, conv1x1_designs=conv_designs,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_mem_above_start_gb=(torch.cuda.max_memory_allocated()
                                        - start_mem) / 1e9,
               conv2d_fp32=conv2d, card=card)
    log(f"resnet_fit: hapi Model.fit ResNet-50 NHWC fp32 b{RESNET_B} "
        f"{RESNET_HW}x{RESNET_HW}, default TF32 flags: step "
        f"{step_ms:.2f} ms (median of {RESNET_FIT_STEPS}), "
        f"{res['images_per_s']:.1f} images/s, MFU {res['mfu']:.4f} "
        f"(model FLOPs {flops:.4e} over {BF16_PEAK:.0e}), peak memory "
        f"{res['peak_mem_gb']:.2f} GB, {res['peak_mem_above_start_gb']:.2f}"
        f" GB above the phase's start [{card}]")
    log(f"resnet_fit: loss {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"resnet_fit: 1x1 conv launches a step by design "
        f"{json.dumps(conv_designs)}")
    if not (all(np.isfinite(losses)) and losses[1] < losses[0]
            and max(losses) < 3 * losses[0]):
        raise AssertionError(f"resnet_fit: the loss did not fall after the "
                             f"first step, or left its bound: {losses}")
    x = torch.from_numpy(imgs).cuda()
    y = torch.from_numpy(labels).cuda()
    with default_tf32_flags():
        res["graphs"] = graph_summary(m._train_step)
        res["capture"] = paired_capture("resnet_fit", m._train_step, (x, y),
                                        RESNET_FIT_STEPS, card)
        m._train_step.release_graphs()
        del m, net
        torch.cuda.empty_cache()

        def build():
            from paddle_tpu_torch.hapi.model import _apply_loss
            from paddle_tpu_torch.jit import TrainStep
            net = resnet50(data_format="NHWC", device="cuda",
                           generator=torch.Generator().manual_seed(0))
            return TrainStep(
                net, lambda out, lab: _apply_loss(F.cross_entropy, out, lab),
                optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                   parameters=net.parameters()))

        other = (torch.flip(x, (0,)), torch.flip(y, (0,)))
        res["gate"] = capture_gate("resnet_fit", build, [(x, y), other],
                                   GATE_STEPS, RESNET_PER_STEP)
    return res


# ----------------- phase 24: observe (the observability plane) -----------------

#: steps of the observed Model.fit run, and of each paired round's fits
OBSERVE_STEPS = 12
#: the observed fit's 0-based step before which /profile?steps=2 is armed:
#: the capture starts its trace at note_step(ARM + 1) (step ARM + 2,
#: 1-based, is its lead-in) and spans steps ARM + 3 and ARM + 4, closing
#: at note_step(ARM + 4)
OBSERVE_ARM = 5
#: paired rounds of the fit with the monitor and the server on against off
OBSERVE_ROUNDS = 3
#: the kernels of the fit step and of a decode iteration, by the name of the
#: one CUDA kernel each wrapper launch makes in a Kineto trace (the layer
#: norm backward's second pass, column_sums_kernel<layer_norm_bwd_sums>,
#: and paged attention's merge are not the counted launch)
KINETO_KERNELS = {
    "layer_norm": r"layer_norm_fwd_(hold|stream)_kernel",
    "layer_norm_bwd": r"layer_norm_bwd_(hold|stream)_kernel",
    "flash_attention": r"flash_fwd_(tc_|tf32_)?kernel",
    "flash_attention_bwd": r"flash_bwd_(tc_|tf32_)?kernel",
    "softmax_ce_fwd": r"ce_fwd_(rows|stream)_kernel",
    "softmax_ce_bwd": r"ce_bwd_(rows|stream)_kernel",
    "paged_attention": r"paged_attn_part_kernel",
}
#: the families /metrics must carry during the observed fit
OBSERVE_FAMILIES = ("jit_cache_hits_total", "jit_cache_misses_total",
                    "jit_retraces_total", "xla_compiles_total",
                    "xla_compile_seconds", "xla_compile_cache_events_total",
                    "device_memory_bytes_in_use", "device_memory_peak_bytes")
#: serving: prompts of the observed engine and new tokens each; the steps
#: of its profiled window
OBSERVE_PROMPTS, OBSERVE_NEW, OBSERVE_SERVE_STEPS = (40, 100, 200, 300), 10, 6


def http(port, path, body=None, timeout=120):
    """(status, parsed JSON or text, headers) of a GET, or of a POST of
    `body` (JSON), against the local server on `port`."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, text, hdrs = r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        code, text, hdrs = e.code, e.read().decode(), dict(e.headers)
    try:
        return code, json.loads(text), hdrs
    except ValueError:
        return code, text, hdrs


def kineto_counts(path, within):
    """{kernel: launches} of KINETO_KERNELS in a Kineto chrome trace and
    the total work time (kernels, copies, sets) in ms, both between the
    first start and the last end of the card-side projections of the
    ranges named `within` (a window's lead-in lies before them)."""
    import re
    from paddle_tpu_torch.profiler import xplane
    evs = xplane.load_trace(path).get("traceEvents", [])
    wins = [(e["ts"], e["ts"] + e["dur"]) for e in evs
            if e.get("cat") == "gpu_user_annotation"
            and e.get("name") == within]
    if not wins:
        raise AssertionError(f"observe: no card-side {within!r} range in "
                             f"{path}")
    lo, hi = min(w[0] for w in wins), max(w[1] for w in wins)
    works = [e for e in xplane.work_events(evs) if lo <= e["ts"] < hi]
    counts = {k: sum(1 for e in works if e.get("cat") == "kernel"
                     and re.search(pat, e.get("name", "")))
              for k, pat in KINETO_KERNELS.items()}
    return counts, sum(float(e.get("dur", 0.0)) for e in works) / 1e3


def wait_for(pred, what, timeout=120.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"observe: timed out waiting for {what}")
        time.sleep(0.01)


def observe_fit(cfg, card):
    """Phase 24, training: GPT-2 small fp32 through hapi Model.fit (b8
    s1024, 12 steps) with PADDLE_TPU_METRICS_PORT=0 and a
    ThroughputMonitor(window=4) writing JSONL; from a client thread
    /healthz, /metrics, /snapshot and /profile?steps=2 in order, the
    capture's kernels held to the launch counters and its train_step
    device time to the trace's; the cap's timer path; the monitor's and
    the server's cost in paired rounds."""
    import threading
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi import callbacks as cb
    from paddle_tpu_torch.io import Dataset
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.profiler import monitor, server, watchdog, xplane

    class Batches(Dataset):
        def __init__(self, n):
            self.n = n

        def __len__(self):
            return self.n * TRAIN_B

        def __getitem__(self, i):
            rng = np.random.default_rng(200 + i)
            return (rng.integers(0, cfg.vocab_size, TRAIN_L),
                    rng.integers(0, cfg.vocab_size, TRAIN_L))

    class Hooks(cb.Callback):
        """Times every step's begin and runs `hooks[step]()` there (the
        training thread, after note_step(step))."""

        def __init__(self, hooks=None):
            super().__init__()
            self.hooks, self.t = hooks or {}, []

        def on_train_batch_begin(self, step, logs=None):
            if step in self.hooks:
                self.hooks[step]()
            self.t.append(time.perf_counter())

    def step_ms(hooks, skip=()):
        gaps = [(b - a) * 1e3 for a, b in zip(hooks.t, hooks.t[1:])]
        return [g for i, g in enumerate(gaps) if i + 1 not in skip and i]

    net = GPT(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    m = Model(net)
    m.prepare(optimizer.AdamW(1e-4, parameters=net.parameters(),
                              weight_decay=0.01), F.cross_entropy)
    flops = model_flops(net, TRAIN_B, TRAIN_L)
    jsonl = os.path.join(OUT_DIR, "observe_steps.jsonl")
    if os.path.exists(jsonl):
        os.remove(jsonl)
    cap = xplane.default_capture()
    watchdog.get_watchdog().reset()
    snaps, client, errors = {}, {}, []
    ready = threading.Event()  # the fit is at step OBSERVE_ARM

    def misses():
        return (watchdog._M_MISSES.value(site="train_step"),
                watchdog._M_HITS.value(site="train_step"))

    misses0 = misses()

    def run_client():
        try:
            if not ready.wait(600):
                raise AssertionError("the fit never reached its arm step")
            srv = server.get_server()
            if srv is None:
                raise AssertionError("Model.fit started no server")
            port = srv.port
            client["healthz"] = http(port, "/healthz")[:2]
            client["metrics"] = http(port, "/metrics")[:2]
            client["snapshot"] = http(port, "/snapshot")[:2]
            client["profile"] = http(port, "/profile?steps=2&timeout=120",
                                     timeout=300)[:2]
        except BaseException as e:  # noqa: B036 - raised on the main thread
            errors.append(e)

    def at_arm():
        ready.set()
        wait_for(lambda: cap.state == "armed" or errors, "/profile's arm")

    hooks = Hooks({OBSERVE_ARM: at_arm,
                   OBSERVE_ARM + 2: lambda: snaps.__setitem__(
                       "start", kernels.all_stats()),
                   OBSERVE_ARM + 4: lambda: snaps.__setitem__(
                       "end", kernels.all_stats())})
    mon = cb.ThroughputMonitor(window=4, jsonl_path=jsonl,
                               samples_per_step=TRAIN_B, flops_per_step=flops)
    th = threading.Thread(target=run_client, daemon=True)
    th.start()
    with env_var("PADDLE_TPU_METRICS_PORT", "0"):
        m.fit(Batches(OBSERVE_STEPS), batch_size=TRAIN_B, epochs=1,
              shuffle=False, verbose=0, callbacks=[hooks, mon])
    th.join(120)
    if errors:
        raise AssertionError(f"observe: the client failed: {errors[0]!r}")
    step = m._train_step
    code, hz = client["healthz"]
    code_m, text = client["metrics"]
    code_s, snap = client["snapshot"]
    code_p, prof = client["profile"]
    if not (code == 200 and hz["status"] == "healthy" and code_m == 200
            and code_s == 200 and code_p == 200):
        raise AssertionError(f"observe: endpoints {code} {hz} {code_m} "
                             f"{code_s} {code_p}")
    missing = [f for f in OBSERVE_FAMILIES
               if f"# HELP paddle_tpu_{f} " not in text]
    if missing or 'device_memory_bytes_in_use{device="cuda:0"}' not in text:
        raise AssertionError(f"observe: /metrics lacks {missing} or the "
                             f"card's memory gauge")
    # exactly one train_step signature, no retrace after the first step
    fam = snap["metrics"]["jit_cache_misses_total"]["values"]
    snap_misses = sum(v["value"] for v in fam
                      if v["labels"].get("site") == "train_step")
    wd = snap["watchdog"]
    new_misses, new_hits = (a - b for a, b in zip(misses(), misses0))
    attribution = snap["compile_attribution"]
    train_entry = attribution.get(f"train_step:{step._wd_name}", {})
    builds = {e: v["phases"]["kernel_build"] for e, v in attribution.items()
              if "kernel_build" in v.get("phases", {})}
    captures = train_entry.get("phases", {}).get("graph_capture", {})
    if not (snap_misses - misses0[0] == 1 == new_misses
            and new_hits == OBSERVE_STEPS - 1
            and wd["total_retraces"] == 0
            and captures.get("count") == step.stats["graph_captures"] == 1
            and (builds or 'xla_compile_cache_events_total{event="hit"}'
                 in text)):
        raise AssertionError(f"observe: signatures {snap_misses} "
                             f"{new_misses} {new_hits}, watchdog {wd}, "
                             f"compile attribution {attribution}")
    # the capture: train_step spans measured from the Kineto trace
    rows = {r["op"]: r for r in prof["device_time"]["rows"]}
    ts_row = rows.get("train_step")
    if not (prof["status"] == "complete" and prof["steps"] == 2 and ts_row
            and ts_row["src"] == "xplane" and ts_row["calls"] == 2
            and "xplane" in prof["summary_table"]):
        raise AssertionError(f"observe: /profile {json.dumps(prof)[:2000]}")
    counted, work_ms = kineto_counts(prof["trace_path"], "train_step")
    window = {k: snaps["end"][k]["kernel"] - snaps["start"][k]["kernel"]
              for k in PER_STEP}
    traced = {k: counted[k] for k in PER_STEP}
    if traced != window or window != {k: 2 * n for k, n in PER_STEP.items()}:
        raise AssertionError(f"observe: the trace's kernels {traced} against "
                             f"the launch counters {window}")
    dev_ms = ts_row["device_ms"]
    if not work_ms > 0 or abs(dev_ms - work_ms) > 0.02 * work_ms:
        raise AssertionError(f"observe: train_step device {dev_ms} ms "
                             f"against the window's work {work_ms} ms")
    records = [json.loads(line) for line in open(jsonl)]
    for rec in records:
        monitor.validate_step_record(rec)
    if [r["step"] for r in records] != [4, 8, 12] or not all(
            r["device_mem_bytes"] for r in records):
        raise AssertionError(f"observe: step records {records}")
    unprofiled = step_ms(hooks, skip=tuple(range(OBSERVE_ARM,
                                                 OBSERVE_ARM + 5)))
    res = dict(
        steps=OBSERVE_STEPS, window=window, traced=traced,
        train_step_device_ms=dev_ms, window_work_ms=work_ms,
        device_vs_work=dev_ms / work_ms - 1.0,
        profiled_step_host_ms=ts_row["host_ms"] / 2,
        device_share_of_step=dev_ms / ts_row["host_ms"],
        unprofiled_step_ms=unprofiled,
        correlation=prof["correlation"], segments=prof["segments"],
        diagnosis=prof.get("diagnosis"), records=records,
        compile_attribution=attribution, kernel_builds=builds,
        graph_capture_s=captures.get("seconds"), healthz=hz,
        cache_events=[line for line in text.splitlines()
                      if line.startswith(
                          "paddle_tpu_xla_compile_cache_events_total")])
    log(f"observe: Model.fit GPT-2 small fp32 b{TRAIN_B} s{TRAIN_L}, "
        f"/profile?steps=2: train_step {dev_ms:.3f} device ms over 2 steps "
        f"against the trace's {work_ms:.3f} ms of work ("
        f"{100 * res['device_vs_work']:+.4f} %), "
        f"{100 * res['device_share_of_step']:.2f} % of the profiled steps' "
        f"{ts_row['host_ms']:.3f} host ms; kernels traced {traced} = "
        f"counted; unprofiled steps "
        f"{min(unprofiled):.3f}-{max(unprofiled):.3f} ms, profiled "
        f"{res['profiled_step_host_ms']:.3f} ms; graph capture "
        f"{captures.get('seconds'):.3f} s; kernel builds {builds}; "
        f"records {[round(r['step_time_ms'], 3) for r in records]} ms, "
        f"MFU {[round(r['mfu_est'], 4) for r in records]} [{card}]")
    log(f"observe: segments {json.dumps(prof['segments']['segments'])}")

    # the cap's timer finalizes a window from its own thread; the trace
    # stops on the training thread at its next step
    timer = {}

    def run_timer_client():
        try:
            timer["profile"] = http(server.get_server().port,
                                    "/profile?steps=100&timeout=1",
                                    timeout=120)[:2]
        except BaseException as e:  # noqa: B036
            errors.append(e)

    def check_stopped():
        timer["enabled_after"] = (
            torch.autograd.profiler._is_profiler_enabled
            or torch._C._autograd._profiler_enabled())

    th = threading.Thread(target=run_timer_client, daemon=True)
    hooks_t = Hooks({
        1: lambda: (th.start(), wait_for(lambda: cap.state == "armed",
                                         "the timer path's arm")),
        3: lambda: (wait_for(lambda: cap.state == "idle",
                             "the timer's finalize", 30),
                    timer.__setitem__("enabled_before", (
                        torch.autograd.profiler._is_profiler_enabled))),
        4: check_stopped})
    with env_var("PADDLE_TPU_METRICS_PORT", "0"):
        m.fit(Batches(6), batch_size=TRAIN_B, epochs=1, shuffle=False,
              verbose=0, callbacks=[hooks_t])
    th.join(60)
    last = cap.last_summary or {}
    if errors or not (timer["profile"][0] == 200
                      and timer["profile"][1]["status"] == "timeout"
                      and timer["enabled_before"] is True
                      and timer["enabled_after"] is False
                      and last.get("trace_path")
                      and os.path.exists(last["trace_path"])
                      and cap.state == "idle"):
        raise AssertionError(f"observe: the timer path {timer} {last} "
                             f"{errors}")
    res["timer_path"] = dict(status=timer["profile"][1]["status"],
                             trace_stopped_on_next_step=True)
    log("observe: the cap's timer finalized a window (status timeout); "
        "the training thread's next step stopped Kineto and wrote the trace")

    # cost of the monitor and the server: paired rounds, on and off in turns
    server.stop_server()
    rounds = []
    for r in range(OBSERVE_ROUNDS):
        pair = {}
        for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
            h = Hooks()
            cbs = [h]
            port = None
            if mode == "on":
                cbs.append(cb.ThroughputMonitor(
                    window=4, jsonl_path=jsonl, samples_per_step=TRAIN_B,
                    flops_per_step=flops))
                port = "0"
            with env_var("PADDLE_TPU_METRICS_PORT", port):
                m.fit(Batches(OBSERVE_STEPS), batch_size=TRAIN_B, epochs=1,
                      shuffle=False, verbose=0, callbacks=cbs)
            if (mode == "on") != (server.get_server() is not None):
                raise AssertionError(f"observe: round {r} {mode}: server "
                                     f"{server.get_server()}")
            server.stop_server()
            pair[mode] = float(np.median(step_ms(h)))
        pair["overhead"] = pair["on"] / pair["off"] - 1.0
        rounds.append(pair)
        log(f"observe: round {r}: step {pair['off']:.3f} ms off, "
            f"{pair['on']:.3f} ms with the monitor and the server "
            f"({100 * pair['overhead']:+.3f} %; the reference's yardstick "
            f"for its sentinel: 2 %) [{card}]")
    res["cost_rounds"] = rounds
    del m, net, step
    free_card()
    return res


def observe_serving(cfg, card):
    """Phase 24, serving: a fused ServingEngine at phase 4's widths behind
    an ObservabilityServer; a Profiler(targets=[CPU, GPU]) window of
    RecordEvent-spanned steps whose trace holds every paged-attention
    launch; 429 at the queue limit, /generate's tokens equal to
    engine.generate's, /requests, /slo, /healthz's serving block, 503 with
    Retry-After while suspended."""
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.profiler import (Profiler, ProfilerTarget,
                                           RecordEvent, make_scheduler)
    from paddle_tpu_torch.profiler.server import ObservabilityServer
    model = GPT(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    model.eval()
    eng = ServingEngine(model, max_batch=8, max_len=1024, page_size=16,
                        name="observe")
    srv = ObservabilityServer()
    port = srv.start(0)  # a server that cannot bind fails the phase
    rng = np.random.default_rng(24)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in OBSERVE_PROMPTS]
    res = {}
    try:
        # warm: the buckets' and the lane width's graphs are captured here,
        # so the profiled window captures none
        for p in prompts:
            eng.submit(p, max_new_tokens=OBSERVE_NEW)
        eng.run_until_idle()
        captures = eng.stats["graph_captures"]
        reqs = [eng.submit(p, max_new_tokens=OBSERVE_NEW) for p in prompts]
        trace_dir = os.path.join(OUT_DIR, "observe_trace")
        # one READY step (the trace's lead-in), then the recorded steps
        prof = Profiler(targets=[ProfilerTarget.CPU, ProfilerTarget.GPU],
                        scheduler=make_scheduler(
                            closed=0, ready=1, record=OBSERVE_SERVE_STEPS,
                            repeat=1), trace_dir=trace_dir)
        prof.start()
        for i in range(OBSERVE_SERVE_STEPS + 1):
            if i == 1:
                before = kernels.all_stats()["paged_attention"]["kernel"]
                iterations = eng.stats["iterations"]
            with RecordEvent("serve_step"):
                eng.step()
            prof.step()
        prof.stop()
        launched = kernels.all_stats()["paged_attention"]["kernel"] - before
        iterations = eng.stats["iterations"] - iterations
        eng.run_until_idle()
        for r in reqs:
            r.result(timeout=60)
        counted, work_ms = kineto_counts(prof.trace_path, "serve_step")
        stats = prof.xplane_stats or {}
        if not (launched == counted["paged_attention"]
                == iterations * SERVE_PAGED > 0
                and eng.stats["graph_captures"] == captures
                and stats.get("correlated") == OBSERVE_SERVE_STEPS):
            raise AssertionError(f"observe: profiled serving window: paged "
                                 f"attention {launched} launched, "
                                 f"{counted['paged_attention']} traced; "
                                 f"correlation {stats}")
        dev = next(r for r in stats["by_op"] if r["op"] == "serve_step")
        res["profiled_window"] = dict(
            steps=OBSERVE_SERVE_STEPS, decode_iterations=iterations,
            paged_attention=launched,
            traced=counted, work_ms=work_ms, serve_step_device_ms=dev[
                "xplane_ms"], host_ms=sum(s.dur_ns for s in prof._spans)
            / 1e6)
        log(f"observe: Profiler window of {OBSERVE_SERVE_STEPS} engine "
            f"steps: {launched} paged-attention launches counted and traced; "
            f"serve_step device {dev['xplane_ms']:.3f} ms of "
            f"{res['profiled_window']['host_ms']:.3f} host ms [{card}]")
        # the admission queue at its limit: 429 (the loop not started yet)
        with env_var("PADDLE_TPU_SERVING_QUEUE_LIMIT", "2"):
            queued = [eng.submit(p, max_new_tokens=2) for p in prompts[:2]]
            code_q, doc_q, _ = http(port, "/generate",
                                    {"prompt": prompts[0]})
        eng.run_until_idle()
        for r in queued:
            r.result(timeout=60)
        eng.start()
        by_http, direct = [], []
        for p in prompts:
            code, doc, _ = http(port, "/generate", {
                "prompt": p, "max_new_tokens": OBSERVE_NEW,
                "temperature": 0.0})
            if code != 200:
                raise AssertionError(f"observe: /generate {code} {doc}")
            by_http.append(doc["tokens"])
            direct.append(eng.generate(p, max_new_tokens=OBSERVE_NEW)[
                "tokens"])
        code_r, doc_r, _ = http(port, "/requests?n=8")
        code_s, doc_s, _ = http(port, "/slo")
        code_h, doc_h, _ = http(port, "/healthz")
        eng.suspend(reason="memory_pressure", retry_after_s=3.0)
        code_u, doc_u, hdr_u = http(port, "/generate", {"prompt": [1, 2]})
        eng.resume_admissions()
        ok = (code_q == 429 and doc_q["limit"] == 2 and by_http == direct
              and code_r == 200 and len(doc_r["completed"]) > 0
              and code_s == 200 and code_h == 200
              and "observe" in doc_h.get("serving", {})
              and code_u == 503 and hdr_u.get("Retry-After") == "3"
              and doc_u.get("retry_after_s") == 3.0)
        res.update(generate_equal=by_http == direct, status_429=code_q,
                   status_503=code_u, retry_after=hdr_u.get("Retry-After"),
                   healthz_serving=doc_h.get("serving"),
                   slo_signals=sorted(doc_s.get("signals", {})))
        if not ok:
            raise AssertionError(f"observe: serving endpoints {res}, "
                                 f"{code_q} {doc_q} {code_r} {code_s} "
                                 f"{code_h} {doc_h} {code_u} {doc_u}")
        log(f"observe: /generate's tokens equal engine.generate's on "
            f"{len(prompts)} prompts; 429 at the queue limit; 503 with "
            f"Retry-After {hdr_u.get('Retry-After')} while suspended; "
            f"/requests, /slo and /healthz's serving block answer")
    finally:
        eng.close()
        srv.stop()
    del model, eng
    free_card()
    return res


def observe(cfg, card):
    """Phase 24: the observability plane on the card (training through
    Model.fit, then serving); its launches counted from 0."""
    from paddle_tpu_torch.ops import kernels
    kernels.reset_stats()
    res = observe_fit(cfg, card)
    res["serving"] = observe_serving(cfg, card)
    res["launches"] = kernels.all_stats()
    return res


# ---------------------- phase 25: the parameter server ----------------------

#: bench.py:1446-1447's widths: B 512, 8 slots, ids uniform in
#: [0, 1,000,000), dim 16, 13 dense features, hidden 64, and a hot-row
#: cache of 32,768 rows a table
PS_B, PS_SLOTS, PS_VOCAB, PS_DIM, PS_DENSE, PS_HIDDEN = (
    512, 8, 1_000_000, 16, 13, 64)
PS_CACHE = 1 << 15
#: |loss difference| allowed between two fp32 runs of one function whose
#: sums are taken in other orders (the eager loop merges duplicate ids by
#: index_add_, the step by embedding's backward; the card against the CPU)
PS_LOSS_TOL = 1e-4


def ps_data(seed=0):
    """bench.py's 8 batches (ids, dense, labels) on the host, drawn as it
    draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(8):
        ids = rng.integers(0, PS_VOCAB, (PS_B, PS_SLOTS)).astype(np.int64)
        dense = rng.normal(size=(PS_B, PS_DENSE)).astype(np.float32)
        labels = (rng.random((PS_B, 1)) > 0.5).astype(np.float32)
        out.append(tuple(torch.from_numpy(a) for a in (ids, dense, labels)))
    return out


@contextlib.contextmanager
def ps_client():
    """A fresh table server on a free port and a client of it; both
    stopped after."""
    from paddle_tpu_torch.distributed.ps import PSClient, PSServer
    server = PSServer(0)
    client = PSClient([server.endpoint])
    try:
        yield client
    finally:
        client.stop_servers()
        server.stop()


def ps_model(client, device, cls="wide_deep"):
    """bench.py's Wide&Deep (or DeepFM at its widths), dense weights from
    seed 0, server SGD 0.05."""
    from paddle_tpu_torch.models import DeepFM, WideDeep
    gen = torch.Generator().manual_seed(0)
    if cls == "deepfm":
        return DeepFM(num_slots=PS_SLOTS, embedding_dim=PS_DIM,
                      hidden=PS_HIDDEN, client=client, device=device,
                      generator=gen)
    return WideDeep(num_slots=PS_SLOTS, embedding_dim=PS_DIM,
                    dense_dim=PS_DENSE, hidden=PS_HIDDEN, client=client,
                    device=device, generator=gen)


def ps_heter(model, mode="sync", cache_capacity=0):
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed.ps.heter import HeterPSTrainStep
    opt = optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    return HeterPSTrainStep(model, nn.BCEWithLogitsLoss(), opt, mode=mode,
                            cache_capacity=cache_capacity)


def ps_eager(data, steps, dev, cls="wide_deep"):
    """The eager PS loop (bench.py:1316's body) with the dense tower on
    ``dev``: every step's loss, and the seconds of the steps after the
    first two."""
    from paddle_tpu_torch import nn, optimizer
    with ps_client() as client:
        model = ps_model(client, dev, cls)
        opt = optimizer.Adam(learning_rate=1e-3,
                             parameters=model.parameters())
        crit = nn.BCEWithLogitsLoss()
        losses = []
        for i in range(steps):
            if i == 2:
                t0 = time.perf_counter()  # loss.item() waited
            ids, dense, labels = data[i % len(data)]
            args = (ids,) if cls == "deepfm" else (ids, dense.to(dev))
            loss = crit(model(*args), labels.to(dev))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        return losses, time.perf_counter() - t0


def ps_sync(data, steps, dev, cls="wide_deep"):
    """Sync HeterPSTrainStep on ``dev``: losses, seconds of the steps after
    the first two, its graph counters, its stage times a step over those
    steps, and the first step's routing ms (the process's first pass over
    ``meta`` tensors loads PyTorch's meta functions)."""
    with ps_client() as client:
        step = ps_heter(ps_model(client, dev, cls))
        try:
            losses = []
            for i in range(steps):
                if i == 1:
                    first_route_ms = 1000 * step.stage_totals["route_s"]
                if i == 2:
                    for k in step.stage_totals:
                        step.stage_totals[k] = 0 if k == "steps" else 0.0
                    t0 = time.perf_counter()  # float(loss) waited
                b = data[i % len(data)]
                losses.append(float(step(*((b[0], b[2]) if cls == "deepfm"
                                           else b))))
            dt = time.perf_counter() - t0
            n = max(step.stage_totals["steps"], 1)
            g = step.stats
            stats = dict(first_route_ms=first_route_ms,
                         graph_captures=g["graph_captures"],
                         graph_replays=sum(g["graph_replays"].values()),
                         graph_pool_bytes=g["graph_pool_bytes"], **{
                             k[:-2] + "_ms": 1000 * v / n
                             for k, v in step.stage_totals.items()
                             if k.endswith("_s")})
        finally:
            step.close()
    return losses, dt, stats


def ps_train(card):
    """Phase 25: Wide&Deep over the parameter server at bench.py's widths
    (B 512, 8 slots, ids in [0, 1,000,000), dim 16, 13 dense features,
    hidden 64; Adam 1e-3 on the dense tower, SGD 0.05 on the server, BCE
    with logits, 8 seeded batches reused in turn): the eager loop, sync
    HeterPSTrainStep against it, 5 sync steps on the CPU against the
    card's, an async probe, the pipelined step with the 32,768-row cache
    and prefetch, and DeepFM's sync step against its eager loop."""
    dev = "cuda"
    data = ps_data(0)
    t_phase = time.perf_counter()
    res = {"widths": dict(B=PS_B, slots=PS_SLOTS, vocab=PS_VOCAB,
                          dim=PS_DIM, dense=PS_DENSE, hidden=PS_HIDDEN,
                          cache_rows=PS_CACHE), "loss_tol": PS_LOSS_TOL}

    # 1. the eager loop: 2 warm-up + 20 timed steps
    eager, dt = ps_eager(data, 22, dev)
    res["eager"] = dict(step_ms=1000 * dt / 20, losses=eager)
    # 2. sync HeterPSTrainStep over the same 22 batches, a fresh server
    sync, dt, stats = ps_sync(data, 22, dev)
    diff = max(abs(a - b) for a, b in zip(sync, eager))
    res["sync"] = dict(step_ms=1000 * dt / 20, losses=sync,
                       max_loss_diff_vs_eager=diff, **stats)
    log(f"ps: eager loop {res['eager']['step_ms']:.3f} ms a step, sync "
        f"heter {res['sync']['step_ms']:.3f} ms (route "
        f"{stats['route_ms']:.3f}, plan {stats['plan_ms']:.3f}, pull "
        f"{stats['pull_ms']:.3f}, h2d {stats['put_ms']:.3f}, dispatch "
        f"{stats['dispatch_ms']:.3f}, push {stats['push_ms']:.3f} ms a "
        f"step; the first step's route {stats['first_route_ms']:.1f} ms; "
        f"graph captures {stats['graph_captures']}, replays "
        f"{stats['graph_replays']}); max |loss diff| {diff:.2e} (tol "
        f"{PS_LOSS_TOL}) over 22 steps [{card}]")
    if not all(math.isfinite(x) for x in sync + eager) or diff > PS_LOSS_TOL:
        raise AssertionError(f"ps: sync heter against the eager loop: "
                             f"{sync} vs {eager}")
    if stats["graph_captures"] < 1 or stats["graph_replays"] < 20:
        raise AssertionError(f"ps: the sync step did not replay a graph: "
                             f"{stats}")
    # 3. 5 sync steps on the CPU against the card's first 5
    cpu, _, _ = ps_sync(data, 5, "cpu")
    diff = max(abs(a - b) for a, b in zip(cpu, sync[:5]))
    res["cpu_cross_check"] = dict(losses=cpu, max_loss_diff=diff)
    log(f"ps: 5 sync steps on the CPU against the card's: max |loss diff| "
        f"{diff:.2e} (tol {PS_LOSS_TOL})")
    if diff > PS_LOSS_TOL:
        raise AssertionError(f"ps: CPU {cpu} vs card {sync[:5]}")

    # 4 and 5 on one server and one model, as bench.py:1468-1520
    with ps_client() as client:
        model = ps_model(client, dev)
        # 4. async probe: 2 warm-up steps, 10 timed, then flush()
        step = ps_heter(model, "async")
        try:
            for b in data[:2]:
                step(*b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(10):
                loss = step(*data[i % len(data)])
            step.flush()
            torch.cuda.synchronize()
            res["async"] = dict(step_ms=1000 * (time.perf_counter() - t0)
                                / 10, final_loss=float(loss))
        finally:
            step.close()
        # 5. pipelined with the hot-row cache and prefetch; its memory is
        # the peak above what was allocated when it began
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        step = ps_heter(model, "pipelined", PS_CACHE)
        try:
            for b in data + data:  # fills the cache; captures the graphs
                step(*b)
            step.flush()
            for k in step.stage_totals:
                step.stage_totals[k] = 0 if k == "steps" else 0.0
            caches = list(step.caches.values())
            before = {k: sum(c.stats[k] for c in caches)
                      for k in ("hit", "miss", "device_gather")}
            replays0 = sum(step.stats["graph_replays"].values())
            iters = 30
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(iters):
                loss = step(*data[i % len(data)])
                if i + 1 < iters:
                    step.prefetch(*data[(i + 1) % len(data)])
            step.flush()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            totals = dict(step.stage_totals)
            timed_replays = sum(step.stats["graph_replays"].values()) \
                - replays0
            ts = time.perf_counter()
            for i in range(iters, iters + 5):
                last = float(step(*data[i % len(data)]))
            synced = (time.perf_counter() - ts) / 5
            stats = step.stats
            peak = torch.cuda.max_memory_allocated() - mem0
        finally:
            step.close()
    n = max(totals["steps"], 1)
    hits = sum(c.stats["hit"] for c in caches)
    misses = sum(c.stats["miss"] for c in caches)
    gathered = sum(c.stats["device_gather"] for c in caches)
    timed = {k: sum(c.stats[k] for c in caches) - v
             for k, v in before.items()}
    pipe = dict(
        step_wall_ms=1000 * wall / iters, synced_step_ms=1000 * synced,
        route_ms=1000 * totals["route_s"] / n,
        pull_ms=1000 * totals["pull_s"] / n,
        h2d_ms=1000 * totals["put_s"] / n,
        push_ms=1000 * totals["push_s"] / n,
        plan_ms=1000 * totals["plan_s"] / n,
        dispatch_ms=1000 * totals["dispatch_s"] / n,
        hits=hits, misses=misses, hit_rate=hits / max(hits + misses, 1),
        timed_hits=timed["hit"], timed_misses=timed["miss"],
        evictions=sum(c.stats["eviction"] for c in caches),
        overflow=sum(c.stats["overflow"] for c in caches),
        writebacks=sum(c.stats["writeback"] for c in caches),
        device_gather_rows=gathered,
        graph_captures=stats["graph_captures"],
        graph_replays=sum(stats["graph_replays"].values()),
        timed_replays=timed_replays,
        graph_pool_bytes=stats["graph_pool_bytes"],
        peak_memory_bytes=peak, allocated_before_bytes=mem0,
        final_loss=last,
        cache_devices=sorted({str(t.device) for c in caches
                              for t in (c.values, c.gsum)}))
    pipe["sparse_host_ms"] = pipe["route_ms"] + pipe["pull_ms"] \
        + pipe["h2d_ms"]
    res["pipelined"] = pipe
    log(f"ps: pipelined + cache {pipe['step_wall_ms']:.3f} ms a step "
        f"(synced {pipe['synced_step_ms']:.3f} ms; route "
        f"{pipe['route_ms']:.3f}, pull {pipe['pull_ms']:.3f}, h2d "
        f"{pipe['h2d_ms']:.3f}, plan {pipe['plan_ms']:.3f}, dispatch "
        f"{pipe['dispatch_ms']:.3f}, push {pipe['push_ms']:.3f} ms a step), "
        f"async probe {res['async']['step_ms']:.3f} ms; hit rate "
        f"{pipe['hit_rate']:.4f} (timed {timed['hit']} hits, "
        f"{timed['miss']} misses), evictions {pipe['evictions']}, overflow "
        f"{pipe['overflow']}; graphs {pipe['graph_captures']} captured, "
        f"{pipe['timed_replays']} replays in the timed steps; peak "
        f"{peak / 2**20:.1f} MiB above the {mem0 / 2**20:.1f} MiB allocated "
        f"before it [{card}]")
    if pipe["cache_devices"] != ["cuda:0"]:
        raise AssertionError(f"ps: cache buffers on {pipe['cache_devices']}")
    if gathered != hits or timed["hit"] != timed["device_gather"]:
        raise AssertionError(f"ps: hits {hits} but {gathered} rows served "
                             f"by the gather on the card")
    if pipe["timed_replays"] != iters or not math.isfinite(last):
        raise AssertionError(f"ps: pipelined step: {pipe}")

    # 6. DeepFM: 5 sync steps against its eager loop
    fm_eager, _ = ps_eager(data, 5, dev, "deepfm")
    fm, dt, fm_stats = ps_sync(data, 5, dev, "deepfm")
    diff = max(abs(a - b) for a, b in zip(fm, fm_eager))
    res["deepfm"] = dict(step_ms=1000 * dt / 3, losses=fm,
                         eager_losses=fm_eager, max_loss_diff=diff,
                         **fm_stats)
    log(f"ps: DeepFM sync {res['deepfm']['step_ms']:.3f} ms a step; max "
        f"|loss diff| against its eager loop {diff:.2e} [{card}]")
    if not all(math.isfinite(x) for x in fm) or diff > PS_LOSS_TOL:
        raise AssertionError(f"ps: DeepFM {fm} vs eager {fm_eager}")
    res["phase_s"] = time.perf_counter() - t_phase
    free_card()
    return res


# ---------------------- phase 26: collective data parallelism ----------------------

#: GPT-3 1.3B under DataParallel: B 4 x L 2048 (8,192 tokens a step)
GPT3_B, GPT3_L = 4, 2048
GPT3_WARMUP, GPT3_STEPS = 2, 6
#: steps of the world-1 comparison and of the two gloo ranks
DP_STEPS, DP_RANK_STEPS = 6, 3
#: two ranks against one process (fp32, 3 AdamW steps at lr 1e-4): each
#: group-mean loss within DP_LOSS_ATOL; each parameter within 2 * lr *
#: steps (an element whose gradient is rounding noise moves by about lr a
#: step either way) and at most DP_PARAM_FRAC of its elements beyond
#: DP_PARAM_ATOL (the reduction order and cuBLAS's choices at M 4,096 and
#: 8,192 differ)
DP_LOSS_ATOL, DP_PARAM_ATOL, DP_PARAM_FRAC = 1e-3, 1e-5, 1e-2
DP_LR = 1e-4


def remat_full_per_step(layers):
    """Launches a step of a GPT under remat "full" at a length that takes
    the one-pass backward: the forward's layer norms and attention run
    again in the backward."""
    return {"layer_norm": 4 * layers + 1, "layer_norm_bwd": 2 * layers + 1,
            "flash_attention": 2 * layers, "flash_attention_bwd": layers,
            "softmax_ce_fwd": 1, "softmax_ce_bwd": 1}


def dp_step(cfg, dev, dp=True, amp=torch.bfloat16, gen_seed=0,
            fused_opt=None):
    """TrainStep of GPT(cfg) (inside DataParallel when ``dp``) under
    AdamW(1e-4, wd 0.01): the phase's step."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.nn import functional as F
    net = GPT(cfg, device=dev, generator=torch.Generator().manual_seed(
        gen_seed))
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=net.parameters(),
                          weight_decay=0.01)
    return TrainStep(dist.DataParallel(net) if dp else net, F.cross_entropy,
                     opt, amp_dtype=amp, fused_opt=fused_opt)


def nccl_kernels(fn):
    """(kernels whose name holds "nccl", all kernels) in one call of `fn`
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum("nccl" in n.lower() for n in names), len(names)


def dp_world1(cfg, card):
    """World 1 over NCCL: every collective on the card against the
    reference's answer for one rank; TrainStep(DataParallel(GPT-2 small))
    captured, bit for bit against TrainStep(GPT-2 small) over 6 steps
    under deterministic_steps, with the all-reduces in every replay; a
    capture that fails after its all-reduces, and the group afterwards."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.ops import kernels
    dev = torch.device("cuda")
    dist.init_parallel_env()
    res = dict(backend=dist.get_backend(), rank=dist.get_rank(),
               world=dist.get_world_size(), card=card)
    if res["backend"] != "nccl" or res["world"] != 1:
        raise AssertionError(f"dp: world {res}")
    # 1. each collective of one rank: the reference's answer on one device
    x0 = torch.arange(6, dtype=torch.float32, device=dev).reshape(1, 3, 2)
    want = x0.clone()
    checks = {}
    for name, op in (("all_reduce_sum", dist.ReduceOp.SUM),
                     ("all_reduce_max", dist.ReduceOp.MAX),
                     ("all_reduce_prod", dist.ReduceOp.PROD),
                     ("all_reduce_avg", dist.ReduceOp.AVG)):
        checks[name] = dist.all_reduce(x0.clone(), op=op)
    checks["broadcast"] = dist.broadcast(x0.clone(), src=0)
    checks["reduce"] = dist.reduce(x0.clone(), dst=0)
    checks["all_gather"] = dist.all_gather(None, x0)[0]
    checks["all_gather_axis1"] = dist.all_gather(None, x0, axis=1)
    sc = torch.zeros_like(x0)
    checks["scatter"] = dist.scatter(sc, [x0], src=0)
    rs = torch.zeros_like(x0)
    checks["reduce_scatter"] = dist.reduce_scatter(rs, x0)
    checks["alltoall"] = dist.alltoall(x0)
    checks["ppermute"] = dist.ppermute(x0)
    checks["shard_batch"] = dist.shard_batch(x0)
    objs = dist.all_gather_object([], {"v": 7})
    dist.barrier()
    bad = [k for k, v in checks.items() if not torch.equal(v, want)]
    if bad or objs != [{"v": 7}]:
        raise AssertionError(f"dp: collectives of one rank differ from the "
                             f"reference's answer: {bad} {objs}")
    res["collectives"] = sorted(checks) + ["all_gather_object", "barrier"]
    log(f"dp: world 1 over {res['backend']}: {len(res['collectives'])} "
        f"collectives on the card give the reference's one-rank answer")
    # 2. the grouped step against the plain one, both captured, bit for bit
    rng = np.random.default_rng(0)
    batches = [tuple(torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        TRAIN_B, TRAIN_L))).to(dev) for _ in range(2)) for _ in range(2)]
    runs = {}
    for name, grouped in (("plain", False), ("dp", True)):
        torch.manual_seed(0)
        step = dp_step(cfg, dev, dp=grouped)
        C.reset_launch_stats()
        kernels.reset_stats()
        losses = []
        with deterministic_steps():
            for i in range(DP_STEPS):
                losses.append(step(*batches[i % 2]))
            torch.cuda.synchronize()
        runs[name] = dict(losses=torch.stack(losses).cpu(),
                          state=step_state(step), graphs=graph_summary(step),
                          stats=kernels.all_stats(),
                          collectives=C.launch_stats())
        if grouped:
            nccl, total = nccl_kernels(lambda: step(*batches[0]))
            runs[name]["profile"] = dict(nccl_kernels=nccl, kernels=total)
            runs[name]["buckets"] = len(step._buckets)
        step.release_graphs()
        del step
        free_card()
    p, d = runs["plain"], runs["dp"]
    same = bits_equal(p["losses"], d["losses"])
    diff = [k for k, v in p["state"].items()
            if not bits_equal(v, d["state"][k])]
    per_step = d["buckets"] + 2  # the buckets, the label count, the loss
    want_coll = {"all_reduce": per_step * DP_STEPS}
    res["gpt2_world1"] = dict(
        steps=DP_STEPS, losses=d["losses"].tolist(), losses_bit_for_bit=same,
        state_tensors=len(p["state"]), state_differing=diff,
        graphs=d["graphs"], buckets=d["buckets"],
        collectives=d["collectives"], collectives_want=want_coll,
        replay_profile=d["profile"], launches=d["stats"])
    log(f"dp: TrainStep(DataParallel(GPT-2 small)) captured, O2 b{TRAIN_B} "
        f"s{TRAIN_L}, against TrainStep(GPT-2 small), {DP_STEPS} steps "
        f"under deterministic_steps: losses bit for bit {same}, {len(diff)} "
        f"of {len(p['state'])} masters/slots/buffers differ; all-reduces "
        f"{d['collectives']} (want {want_coll}: {d['buckets']} buckets, "
        f"the label count and the loss a step); one replay under the "
        f"profiler: {d['profile']['nccl_kernels']} NCCL kernels of "
        f"{d['profile']['kernels']}; graphs {json.dumps(d['graphs'])}")
    if not same or diff or d["collectives"] != want_coll:
        raise AssertionError(f"dp: world-1 step: {res['gpt2_world1']}")
    if p["graphs"]["captures"] != d["graphs"]["captures"]:
        raise AssertionError(f"dp: graphs {p['graphs']} {d['graphs']}")
    # the all-reduces' cost: both steps captured, timed in turns
    steps = {name: dp_step(cfg, dev, dp=grouped)
             for name, grouped in (("plain", False), ("dp", True))}
    ms = {name: [] for name in steps}
    for name, st in steps.items():
        for _ in range(2):
            st(*batches[0])
    for _ in range(CAPTURE_ROUNDS):
        for name, st in steps.items():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(DP_STEPS):
                st(*batches[0])
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t1) * 1e3 / DP_STEPS)
    busy = {name: device_ops(lambda: st(*batches[0]))[1]
            for name, st in steps.items()}
    res["gpt2_world1"]["step_ms"] = ms
    res["gpt2_world1"]["device_busy_ms"] = busy
    log(f"dp: GPT-2 small O2 b{TRAIN_B} s{TRAIN_L} captured, step ms in "
        f"turns (runs of {DP_STEPS}): plain {json.dumps(ms['plain'])}, "
        f"DataParallel world 1 {json.dumps(ms['dp'])}; device busy a step "
        f"{json.dumps(busy)} [{card}]")
    for st in steps.values():
        st.release_graphs()
    del steps, st
    free_card()
    # 3. captures that fail after their all-reduces, by a wait the capture
    # refuses (the capture does not end) and by a Python error (it ends):
    # the group still answers and the step captures again
    small = dataclasses.replace(cfg, num_layers=2)
    res["failed_captures"] = {}
    for how in ("wait", "python"):
        step = dp_step(small, dev)
        apply_fn = step.optimizer.apply_fn

        def failing(*a, **k):
            if torch.cuda.is_current_stream_capturing():
                if how == "wait":
                    float(a[1][next(iter(a[1]))].sum())
                else:
                    raise RuntimeError("a Python error inside the capture")
            return apply_fn(*a, **k)

        step.optimizer.apply_fn = failing
        try:
            step(*batches[0])
            raise AssertionError(f"dp: a capture failing by {how} did not "
                                 f"fail")
        except RuntimeError as e:
            err = str(e)[:160]
        step.optimizer.apply_fn = apply_fn
        one = torch.ones(3, device=dev)
        dist.all_reduce(one)
        losses = [float(step(*batches[1])) for _ in range(2)]
        if not (torch.equal(one, torch.ones(3, device=dev))
                and all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"dp: after a failed capture ({how}): "
                                 f"{one} {losses}")
        res["failed_captures"][how] = dict(error=err, losses=losses,
                                           graphs=graph_summary(step))
        log(f"dp: a capture failing by {how} after its all-reduces raised "
            f"({err[:70]}...); the group answers and the step captures "
            f"again: losses {losses[0]:.4f} {losses[1]:.4f}")
        del step
        free_card()
    return res


def gpt3_rows(dev, gen):
    """The kernels at GPT-3 1.3B's shapes (B 4 L 2048, hidden 2048, 16
    heads of D 128, V 50304, bf16 under O2) against their plain versions."""
    R = GPT3_B * GPT3_L
    rows = (check_layer_norm(dev, gen, (R,), 2048, dtypes=(torch.bfloat16,))
            + check_layer_norm_bwd(dev, gen, R, 2048, torch.bfloat16)
            + check_flash(dev, gen, (GPT3_L,), 16, 128, B=GPT3_B,
                          dtypes=(torch.bfloat16,))
            + check_flash_bwd(dev, gen, (GPT3_L,), GPT3_B, 16, 128,
                              dtypes=(torch.bfloat16,))
            + check_ce(dev, gen, R, 50304, dtypes=(torch.bfloat16,)))
    for r in rows:
        r.setdefault("tol_ratio", r["max_abs_err"] / r.get("tol", 1.0))
        r.setdefault("design", "cuda-core")
        lib = ("-" if r["library_ms"] is None else f"{r['library_ms']:.4f}")
        log(f"kernel {r['kernel']:<19} {r['dtype']:<8} {r['shape']:<30} "
            f"{r['design']:<9} err {r['max_abs_err']:.2e} (/tol "
            f"{r['tol_ratio']:.3f})  kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {lib} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) [GPT-3 1.3B]")
    bad = [r for r in rows if r["tol_ratio"] > 1.0]
    if bad:
        raise AssertionError(f"dp: kernels at GPT-3 1.3B's shapes disagree "
                             f"with their plain versions: {bad}")
    return rows


def gpt3_train(card):
    """GPT-3 1.3B at full width and depth, remat "full", O2 bf16, AdamW,
    through TrainStep(DataParallel(...)) captured on the world-1 NCCL
    group at B 4 x L 2048: step ms (median), device busy, peak memory,
    tokens/s, MFU and exact launches a step."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.ops import kernels
    dev = torch.device("cuda")
    cfg = GPTConfig.gpt3_1p3b()
    cfg.dropout = cfg.attn_dropout = 0.0
    cfg.remat = "full"
    free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the per-parameter update: the grouped one's out-of-place
    # multi-tensor ops hold several parameter-sized temporaries at once
    # (5.3 GB each here), which with the capture's own pool overflow 80 GB
    step = dp_step(cfg, dev, fused_opt=False)
    model = step.layer._layers
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    ids, labels = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        GPT3_B, GPT3_L))).to(dev) for _ in range(2))
    losses = [float(step(ids, labels)) for _ in range(GPT3_WARMUP)]
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    kernels.reset_stats()
    C.reset_launch_stats()
    times = []
    for _ in range(GPT3_STEPS):
        t1 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(loss))
    stats = kernels.all_stats()
    coll = C.launch_stats()
    no_composed("dp_gpt3")
    want = remat_full_per_step(cfg.num_layers)
    for name, st in stats.items():
        if st["plain"] != 0 or st["kernel"] != want.get(name, 0) * GPT3_STEPS:
            raise AssertionError(f"dp: GPT-3 1.3B: {name} counters {st}, "
                                 f"want {want.get(name, 0)} kernel launches "
                                 f"a step and no plain run")
    ops, busy = device_ops(lambda: step(ids, labels))
    step_ms = float(np.median(times)) * 1e3
    flops = model_flops(model, GPT3_B, GPT3_L)
    ln_v = math.log(cfg.vocab_size)
    res = dict(config="gpt3_1p3b", hidden=cfg.hidden_size,
               layers=cfg.num_layers, heads=cfg.num_heads,
               vocab=cfg.vocab_size, remat=cfg.remat, batch=GPT3_B,
               seq=GPT3_L, params=n_params, warmup=GPT3_WARMUP,
               steps=GPT3_STEPS, losses=losses, step_ms=step_ms,
               step_ms_all=[t * 1e3 for t in times],
               device_ops=ops, device_busy_ms=busy,
               tokens_per_s=GPT3_B * GPT3_L / (step_ms / 1e3),
               model_flops=flops, mfu=flops / (step_ms / 1e3) / BF16_PEAK,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               buckets=len(step._buckets), collectives=coll,
               fused_opt=step.fused_opt,
               launches=stats, launches_per_step=want,
               build_and_warmup_s=build_s, card=card)
    log(f"dp: GPT-3 1.3B ({n_params / 1e9:.3f} B parameters, remat full) "
        f"O2 bf16 b{GPT3_B} s{GPT3_L} through TrainStep(DataParallel) "
        f"captured: step {step_ms:.2f} ms (median of {GPT3_STEPS}: "
        f"{json.dumps([round(t * 1e3, 3) for t in times])}), device busy "
        f"{busy} ms of one step ({ops} operations), "
        f"{res['tokens_per_s']:.1f} tokens/s, MFU {res['mfu']:.4f} (model "
        f"FLOPs {flops:.4e} over {BF16_PEAK:.0e}), peak memory "
        f"{res['peak_mem_gb']:.2f} GB, {res['buckets']} gradient buckets, "
        f"all-reduces {coll} [{card}]")
    log(f"dp: GPT-3 1.3B loss {' '.join(f'{x:.4f}' for x in losses)} "
        f"(ln V = {ln_v:.4f}); launches per step {json.dumps(want)}")
    if not (all(math.isfinite(x) for x in losses)
            and abs(losses[0] - ln_v) < 0.1):
        raise AssertionError(f"dp: GPT-3 1.3B losses {losses}: the first "
                             f"must be finite within 0.1 of ln V {ln_v}")
    step.release_graphs()
    del step, model
    free_card()
    return res


def dp_rank_worker(outdir):
    """One rank of the two-rank gloo run (started by the launcher): GPT-2
    small fp32 through the eager DataParallel loop, global batch 8 (its 4
    rows) x 1024, AdamW, 3 steps; writes its losses, launch counters and
    (rank 0) its parameters."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    r = dist.get_rank()
    dev = dist.parallel.rank_device()
    cfg = GPTConfig.gpt2_small()
    cfg.dropout = cfg.attn_dropout = 0.0
    net = GPT(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    dp = dist.DataParallel(net)
    opt = optimizer.AdamW(learning_rate=DP_LR, parameters=dp.parameters(),
                          weight_decay=0.01)
    ids, labels = dp_rank_batch(cfg)
    ids, labels = (dist.shard_batch(t).to(dev) for t in (ids, labels))
    kernels.reset_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(DP_RANK_STEPS):
        loss = F.cross_entropy(dp(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    out = dict(rank=r, backend=dist.get_backend(), device=str(dev),
               losses=losses, stats=kernels.all_stats(),
               seconds=time.perf_counter() - t0)
    if r == 0:
        out["params"] = {k: v.detach().cpu() for k, v in
                         net.named_parameters()}
    torch.save(out, os.path.join(outdir, f"rank{r}.pt"))
    dist.destroy_process_group()


def dp_rank_batch(cfg):
    rng = np.random.default_rng(1)
    return tuple(torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        TRAIN_B, TRAIN_L))) for _ in range(2))


def dp_two_ranks(card):
    """Two gloo ranks on the one card (the launcher, --nproc_per_node 2)
    against one process over the global batch: group-mean losses and
    final parameters within the stated tolerance; each rank's kernel
    counters above 0 and its plain counters 0."""
    import signal
    import tempfile
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import functional as F
    free_card()
    out = tempfile.mkdtemp(prefix="dp_ranks_")
    env = dict(os.environ, PADDLE_DISTRI_BACKEND="gloo")
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ENDPOINTS", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--log_dir", os.path.join(out, "log"),
         os.path.abspath(__file__), "--dp-worker", out],
        env=env, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        raise AssertionError(f"dp: the two ranks did not end within 300 s:"
                             f"\n{text[-3000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(30)
    ranks_s = time.perf_counter() - t0
    worker_log = ""
    logf = os.path.join(out, "log", "workerlog.1")
    if os.path.exists(logf):
        with open(logf) as f:
            worker_log = f.read()[-3000:]
    if proc.returncode != 0:
        raise AssertionError(f"dp: the launcher exited {proc.returncode}:\n"
                             f"{text[-3000:]}\nrank 1:\n{worker_log}")
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    # the same model and global batch in one process
    cfg = GPTConfig.gpt2_small()
    cfg.dropout = cfg.attn_dropout = 0.0
    dev = torch.device("cuda")
    net = GPT(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    opt = optimizer.AdamW(learning_rate=DP_LR, parameters=net.parameters(),
                          weight_decay=0.01)
    ids, labels = (t.to(dev) for t in dp_rank_batch(cfg))
    single = []
    for _ in range(DP_RANK_STEPS):
        loss = F.cross_entropy(net(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        single.append(float(loss))
    loss_diff = max(abs(a - b) for rk in ranks
                    for a, b in zip(rk["losses"], single))
    worst, worst_frac = 0.0, 0.0
    for k, p in net.named_parameters():
        d = (ranks[0]["params"][k].to(dev) - p.detach()).abs()
        worst = max(worst, float(d.max()))
        worst_frac = max(worst_frac, float((d > DP_PARAM_ATOL).float()
                                           .mean()))
    bound = 2 * DP_LR * DP_RANK_STEPS
    res = dict(ranks=[dict(rank=rk["rank"], backend=rk["backend"],
                           device=rk["device"], losses=rk["losses"],
                           seconds=rk["seconds"]) for rk in ranks],
               single_losses=single, max_loss_diff=loss_diff,
               max_param_diff=worst, max_frac_beyond_atol=worst_frac,
               tolerance=dict(loss_atol=DP_LOSS_ATOL, param_max=bound,
                              param_atol=DP_PARAM_ATOL,
                              param_frac=DP_PARAM_FRAC),
               launches_by_rank=[rk["stats"] for rk in ranks],
               launches={k: {"kernel": sum(rk["stats"][k]["kernel"]
                                           for rk in ranks),
                             "plain": sum(rk["stats"][k]["plain"]
                                          for rk in ranks)}
                         for k in ranks[0]["stats"]},
               seconds=ranks_s, card=card)
    log(f"dp: two gloo ranks on one card (launcher, GPT-2 small fp32, b4 a "
        f"rank x s{TRAIN_L}, eager DataParallel, AdamW, {DP_RANK_STEPS} "
        f"steps, {ranks_s:.1f} s with start-up): group-mean losses "
        f"{ranks[0]['losses']} vs one process b{TRAIN_B} {single}: max "
        f"|diff| {loss_diff:.2e} (tol {DP_LOSS_ATOL}); parameters max "
        f"|diff| {worst:.2e} (bound {bound:.1e}), at most "
        f"{worst_frac:.2e} of a tensor's elements beyond {DP_PARAM_ATOL} "
        f"(tol {DP_PARAM_FRAC}) [{card}]")
    for rk in ranks:
        used = {k: st for k, st in rk["stats"].items() if st["kernel"]}
        plain = {k: st for k, st in rk["stats"].items() if st["plain"]}
        if plain or not used:
            raise AssertionError(f"dp: rank {rk['rank']} counters: "
                                 f"{rk['stats']}")
        if rk["losses"] != ranks[0]["losses"]:
            raise AssertionError(f"dp: the ranks' group losses differ: "
                                 f"{[x['losses'] for x in ranks]}")
    if (loss_diff > DP_LOSS_ATOL or worst > bound
            or worst_frac > DP_PARAM_FRAC):
        raise AssertionError(f"dp: two ranks against one process: {res}")
    del net, opt
    free_card()
    import shutil
    shutil.rmtree(out, ignore_errors=True)
    return res


def dp_phase(cfg, card):
    """Phase 26: world 1 over NCCL (collectives, the grouped GPT-2 step bit
    for bit, a failed capture), GPT-3 1.3B through DataParallel, then two
    gloo ranks on the one card."""
    from paddle_tpu_torch import distributed as dist
    t0 = time.perf_counter()
    res = dp_world1(cfg, card)
    res["gpt3_rows"] = gpt3_rows(torch.device("cuda"),
                                 torch.Generator(device="cuda").manual_seed(0))
    res["gpt3"] = gpt3_train(card)
    dist.destroy_process_group()
    res["two_ranks"] = dp_two_ranks(card)
    res["phase_s"] = time.perf_counter() - t0
    log(f"dp: phase 26 took {res['phase_s']:.1f} s [{card}]")
    return res


# -------------- phase 27: ResNet-50 data parallelism (synchronized BN) --------------

#: batch norms of a ResNet-50 step: the 49 fused ones and the 4 downsample
#: BNs (the unfused route); under a group each all-reduces its moments in
#: the forward and its column sums in the backward ("bn_sync")
RESNET_BNS = 53
#: steps of the world-1 comparison (grouped against plain) and of a timed run
RN_DP_STEPS, RN_DP_TIMED = 3, 6
#: the two gloo ranks on the card: ResNet-50 fp32 over a global batch of 32
#: at 224x224 (bench.py's 128 cut for time: two processes share the card),
#: 3 Momentum(0.1, 0.9) steps through the eager DataParallel loop
RN_RANK_B, RN_RANK_STEPS = 32, 3
#: the ranks against one process after the first step: the loss, the
#: parameters and the running statistics each at most RN_NOISE_MULT times
#: the one process's own distance with the global batch reversed (its
#: rounding noise from a reordering: the ranks also regroup every
#: reduction and run cuDNN at another batch) plus a floor: the loss
#: RN_LOSS_FLOOR of itself, the state RN_STATE_FLOOR in relative L2. The
#: later steps are printed and not held: at lr 0.1 on one batch the loss
#: goes 7.2, 5.9, then ~14.7, and that path amplifies the noise of a
#: reordering to ~10 % of the parameters by the third step, differently
#: on every call
RN_NOISE_MULT, RN_LOSS_FLOOR, RN_STATE_FLOOR = 4.0, 1e-5, 1e-5
#: one fp16 BatchNorm2D(64, act="relu") over the two ranks (the composed
#: route): a global [8, 28, 28, 64] batch whose halves' means are 3 apart;
#: against one process, the output within 2^-10 and dx within 2^-8 of
#: their largest magnitude (fp16 results of fp32 arithmetic), the running
#: statistics within 1e-5
RN_FP16_SHAPE = (8, 28, 28, 64)
RN_FP16_OUT_TOL, RN_FP16_DX_TOL, RN_FP16_STAT_TOL = 2.0 ** -10, 2.0 ** -8, 1e-5


def rn_dp_step(dev, grouped):
    """bench.py's ResNet-50 step (NHWC, Momentum(0.1, 0.9), O2 bf16) as a
    TrainStep, over DataParallel when `grouped`; weights from seed 0."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.nn import functional as F
    net = resnet50(data_format="NHWC", device=dev,
                   generator=torch.Generator().manual_seed(0))
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=net.parameters())
    return TrainStep(dist.DataParallel(net) if grouped else net,
                     F.cross_entropy, opt, amp_dtype=torch.bfloat16)


def rn_dp_batch(B, seed=0):
    """NHWC normal images at 224x224 and labels in [0, 1000) on the CPU."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(
        B, RESNET_HW, RESNET_HW, 3)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 1000, (B,))))


def rn_dp_world1(card):
    """World 1 over NCCL: TrainStep(DataParallel(ResNet-50)) captured, O2
    bf16 b128 224x224, against TrainStep(ResNet-50): 3 steps of each under
    deterministic_steps, bit for bit, each with the kernels' exact
    launches and no plain run, the grouped one with its collectives a
    step by kind carried through the replays (2 x 53 "bn_sync", the
    buckets, the label count and the loss); then both captured steps
    timed in turns (step ms, images/s, device busy)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.ops import kernels
    dev = torch.device("cuda")
    dist.init_parallel_env()
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"resnet_dp: world {dist.get_backend()} "
                             f"{dist.get_world_size()}")
    batch = tuple(t.to(dev) for t in rn_dp_batch(RESNET_B))
    runs = {}
    for name, grouped in (("plain", False), ("dp", True)):
        torch.manual_seed(0)
        step = rn_dp_step(dev, grouped)
        C.reset_launch_stats()
        kernels.reset_stats()
        losses = []
        with deterministic_steps():
            for _ in range(RN_DP_STEPS):
                losses.append(step(*batch))
            torch.cuda.synchronize()
        exact_launches(f"resnet_dp {name}", kernels.all_stats(),
                       RESNET_PER_STEP, RN_DP_STEPS)
        no_composed(f"resnet_dp {name}")
        runs[name] = dict(losses=torch.stack(losses).float().cpu(),
                          state=step_state(step), graphs=graph_summary(step),
                          launches=kernels.all_stats(),
                          collectives=C.launch_stats(),
                          buckets=len(step._buckets))
        step.release_graphs()
        del step
        free_card()
    p, d = runs["plain"], runs["dp"]
    same = bits_equal(p["losses"], d["losses"])
    diff = [k for k, v in p["state"].items()
            if not bits_equal(v, d["state"][k])]
    loss_diff = float((p["losses"] - d["losses"]).abs().max())
    param_diff = max(float((v.float() - d["state"][k].float()).abs().max())
                     for k, v in p["state"].items()
                     if k.startswith("param "))
    want_coll = {"bn_sync": 2 * RESNET_BNS * RN_DP_STEPS,
                 "all_reduce": (d["buckets"] + 2) * RN_DP_STEPS}
    res = dict(steps=RN_DP_STEPS, batch=RESNET_B, hw=RESNET_HW,
               losses=d["losses"].tolist(),
               plain_losses=p["losses"].tolist(), losses_bit_for_bit=same,
               max_loss_diff=loss_diff, max_param_diff=param_diff,
               state_tensors=len(p["state"]), state_differing=diff,
               graphs=d["graphs"], buckets=d["buckets"],
               collectives=d["collectives"], collectives_want=want_coll,
               collectives_per_step={k: v / RN_DP_STEPS for k, v in
                                     d["collectives"].items()},
               launches=d["launches"],
               launches_per_step={k: v["kernel"] / RN_DP_STEPS
                                  for k, v in d["launches"].items()},
               card=card)
    log(f"resnet_dp: TrainStep(DataParallel(ResNet-50)) captured on the "
        f"world-1 nccl group, O2 bf16 b{RESNET_B} {RESNET_HW}x{RESNET_HW}, "
        f"against TrainStep(ResNet-50), {RN_DP_STEPS} steps under "
        f"deterministic_steps: losses bit for bit {same} (max |diff| "
        f"{loss_diff:.3e}), parameters max |diff| {param_diff:.3e}, "
        f"{len(diff)} of {len(p['state'])} masters/slots/buffers differ; "
        f"collectives {json.dumps(d['collectives'])} (want "
        f"{json.dumps(want_coll)}: 2 x {RESNET_BNS} bn_sync, "
        f"{d['buckets']} buckets, the label count and the loss a step); "
        f"launches a step {json.dumps(res['launches_per_step'])}; graphs "
        f"{json.dumps(d['graphs'])} [{card}]")
    if not same or diff or d["collectives"] != want_coll:
        raise AssertionError(f"resnet_dp: the world-1 step: {res}")
    if p["collectives"] or p["graphs"]["captures"] != d["graphs"]["captures"]:
        raise AssertionError(f"resnet_dp: plain {p['collectives']} "
                             f"{p['graphs']} {d['graphs']}")
    del runs, p, d
    free_card()
    # both captured steps timed in turns
    steps = {name: rn_dp_step(dev, grouped)
             for name, grouped in (("plain", False), ("dp", True))}
    for st in steps.values():
        for _ in range(2):
            st(*batch)
    ms = {name: [] for name in steps}
    for _ in range(CAPTURE_ROUNDS):
        for name, st in steps.items():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(RN_DP_TIMED):
                st(*batch)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t1) * 1e3 / RN_DP_TIMED)
    busy = {name: device_ops(lambda: st(*batch))
            for name, st in steps.items()}
    nccl, total = nccl_kernels(lambda: steps["dp"](*batch))
    med = {name: float(np.median(v)) for name, v in ms.items()}
    res.update(
        step_ms=ms, step_ms_median=med,
        images_per_s={k: RESNET_B / (v / 1e3) for k, v in med.items()},
        device_ops={k: v[0] for k, v in busy.items()},
        device_busy_ms={k: v[1] for k, v in busy.items()},
        replay_profile=dict(nccl_kernels=nccl, kernels=total),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"resnet_dp: ResNet-50 O2 b{RESNET_B} captured, step ms in turns "
        f"(runs of {RN_DP_TIMED}): plain {json.dumps(ms['plain'])}, "
        f"DataParallel world 1 {json.dumps(ms['dp'])}; images/s "
        f"{json.dumps(res['images_per_s'])}; device ops / busy ms a step "
        f"{json.dumps(busy)}; one grouped replay under the profiler: "
        f"{nccl} NCCL kernels of {total} [{card}]")
    for st in steps.values():
        st.release_graphs()
    del steps, st
    free_card()
    dist.destroy_process_group()
    return res


def rn_fp16_input():
    """The fp16 batch norm's global input (fp32 on the CPU; the halves'
    means 3 apart) and the weights of its sum loss."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=RN_FP16_SHAPE).astype(np.float32)
    x[RN_FP16_SHAPE[0] // 2:] += 3.0
    w = rng.normal(size=RN_FP16_SHAPE).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def rn_fp16_bn(bn, x, w):
    """(output, dx, running mean, running var) of the fp16 fused layer
    `bn` on x (cast to fp16) under the loss sum(out * w)."""
    x16 = x.half().requires_grad_(True)
    out = bn(x16)
    (out.float() * w).sum().backward()
    layer = getattr(bn, "_layers", bn)
    return (out.detach().float().cpu(), x16.grad.float().cpu(),
            layer._mean.detach().cpu(), layer._variance.detach().cpu())


def rn_rank_worker(outdir):
    """One rank of phase 27's two-rank gloo run (started by the launcher):
    ResNet-50 fp32 through the eager DataParallel loop on its 16 rows of
    the global batch, 3 Momentum steps; then one fp16 BatchNorm2D(64,
    act="relu") over the two ranks (the card's composed route). Writes its
    losses, launch and collective counters and (rank 0) its parameters
    and buffers, and its share of the fp16 layer's results."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    r = dist.get_rank()
    dev = dist.parallel.rank_device()
    net = resnet50(data_format="NHWC", device=dev,
                   generator=torch.Generator().manual_seed(0))
    dp = dist.DataParallel(net)
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=dp.parameters())
    xs, ys = (dist.shard_batch(t).to(dev) for t in rn_dp_batch(RN_RANK_B))
    kernels.reset_stats()
    C.reset_launch_stats()
    losses, first = [], None
    t0 = time.perf_counter()
    for i in range(RN_RANK_STEPS):
        loss = F.cross_entropy(dp(xs), ys)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        if i == 0 and r == 0:
            first = rn_state(net)
    out = dict(rank=r, backend=dist.get_backend(), device=str(dev),
               losses=losses, stats=kernels.all_stats(),
               composed=kernels.composed_stats(),
               collectives=C.launch_stats(),
               seconds=time.perf_counter() - t0)
    if r == 0:
        out["first"], out["last"] = first, rn_state(net)
    del dp, net, opt
    x, w = rn_fp16_input()
    dpb = dist.DataParallel(nn.BatchNorm2D(
        RN_FP16_SHAPE[-1], act="relu", data_format="NHWC", device=dev))
    kernels.reset_stats()
    C.reset_launch_stats()
    fp16 = rn_fp16_bn(dpb, dist.shard_batch(x).to(dev),
                      dist.shard_batch(w).to(dev))
    out["fp16"] = dict(out=fp16[0], dx=fp16[1], mean=fp16[2], var=fp16[3],
                       stats=kernels.all_stats(),
                       composed=kernels.composed_stats(),
                       collectives=C.launch_stats())
    torch.save(out, os.path.join(outdir, f"rank{r}.pt"))
    dist.destroy_process_group()


def rn_state(net):
    """(parameters, buffers) of `net`, copied to the CPU."""
    return ({k: v.detach().to("cpu", copy=True)
             for k, v in net.named_parameters()},
            {k: v.detach().to("cpu", copy=True)
             for k, v in net.named_buffers()})


def rn_single(dev, x, y):
    """3 eager Momentum(0.1, 0.9) steps of the same fp32 ResNet-50 in one
    process over the global batch: (losses, rn_state after the first step,
    after the last)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.nn import functional as F
    net = resnet50(data_format="NHWC", device=dev,
                   generator=torch.Generator().manual_seed(0))
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=net.parameters())
    x, y = x.to(dev), y.to(dev)
    losses, first = [], None
    for i in range(RN_RANK_STEPS):
        loss = F.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        if i == 0:
            first = rn_state(net)
    return losses, first, rn_state(net)


def rel_l2_all(a, b):
    """Relative L2 of {name: tensor} a against b, over all tensors."""
    num = sum(float(((a[k].double() - v.double()) ** 2).sum())
              for k, v in b.items())
    den = sum(float((v.double() ** 2).sum()) for v in b.values())
    return (num / max(den, 1e-300)) ** 0.5


def rn_dp_two_ranks(card):
    """Two gloo ranks on the one card (the launcher, --nproc_per_node 2)
    against one process over the global batch: the loss, running
    statistics and parameters after the first step within RN_NOISE_MULT
    times the one process's distance from itself with the batch reversed
    (plus a floor), those after the third printed; each rank's kernels
    launched, no plain run, 2 x 53 bn_sync a step; the fp16 layer through
    the composed route, synchronized, against one process."""
    import shutil
    import signal
    import tempfile
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.ops import kernels
    free_card()
    out = tempfile.mkdtemp(prefix="rn_ranks_")
    env = dict(os.environ, PADDLE_DISTRI_BACKEND="gloo")
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ENDPOINTS", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--log_dir", os.path.join(out, "log"),
         os.path.abspath(__file__), "--rn-worker", out],
        env=env, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        raise AssertionError(f"resnet_dp: the two ranks did not end within "
                             f"300 s:\n{text[-3000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(30)
    ranks_s = time.perf_counter() - t0
    if proc.returncode != 0:
        logf = os.path.join(out, "log", "workerlog.1")
        worker_log = open(logf).read()[-3000:] if os.path.exists(logf) \
            else ""
        raise AssertionError(f"resnet_dp: the launcher exited "
                             f"{proc.returncode}:\n{text[-3000:]}\nrank 1:"
                             f"\n{worker_log}")
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    shutil.rmtree(out, ignore_errors=True)
    dev = torch.device("cuda")
    x, y = rn_dp_batch(RN_RANK_B)
    single = rn_single(dev, x, y)
    free_card()
    flipped = rn_single(dev, x.flip(0), y.flip(0))
    free_card()
    got = (ranks[0]["losses"], ranks[0]["first"], ranks[0]["last"])
    dist_of = {}
    for name, other in (("ranks", got), ("reversed", flipped)):
        dist_of[name] = {}
        for at, i in ((1, 1), (RN_RANK_STEPS, 2)):
            dist_of[name][f"loss_{at}"] = (abs(other[0][at - 1]
                                               - single[0][at - 1])
                                           / abs(single[0][at - 1]))
            dist_of[name][f"params_{at}"] = rel_l2_all(other[i][0],
                                                   single[i][0])
            dist_of[name][f"buffers_{at}"] = rel_l2_all(other[i][1],
                                                    single[i][1])
    # held after the first step only (see RN_NOISE_MULT)
    bound = {k: RN_NOISE_MULT * dist_of["reversed"][k]
             + (RN_LOSS_FLOOR if k.startswith("loss") else RN_STATE_FLOOR)
             for k in ("loss_1", "params_1", "buffers_1")}
    # the fp16 layer in one process
    xh, wh = rn_fp16_input()
    bn = nn.BatchNorm2D(RN_FP16_SHAPE[-1], act="relu", data_format="NHWC",
                        device=dev)
    kernels.reset_stats()
    one = rn_fp16_bn(bn, xh.to(dev), wh.to(dev))
    f16 = [rk["fp16"] for rk in ranks]
    fp16_err = dict(
        out=float((torch.cat([f["out"] for f in f16]) - one[0]).abs().max()
                  / one[0].abs().max()),
        dx=float((torch.cat([f["dx"] for f in f16]) - one[1]).abs().max()
                 / one[1].abs().max()),
        stats=max(float((f[k] - ref).abs().max() / ref.abs().max())
                  for f in f16 for k, ref in (("mean", one[2]),
                                              ("var", one[3]))))
    per_step = {k: v * RN_RANK_STEPS for k, v in RESNET_PER_STEP.items()}
    res = dict(ranks=[dict(rank=rk["rank"], backend=rk["backend"],
                           device=rk["device"], losses=rk["losses"],
                           collectives=rk["collectives"],
                           seconds=rk["seconds"]) for rk in ranks],
               global_batch=RN_RANK_B, steps=RN_RANK_STEPS,
               single_losses=single[0], reversed_losses=flipped[0],
               distance=dist_of, bound=bound,
               launches_by_rank=[rk["stats"] for rk in ranks],
               launches={k: {"kernel": sum(rk["stats"][k]["kernel"]
                                           for rk in ranks),
                             "plain": sum(rk["stats"][k]["plain"]
                                          for rk in ranks)}
                         for k in ranks[0]["stats"]},
               fp16=dict(shape=list(RN_FP16_SHAPE), errors=fp16_err,
                         tolerance=dict(out=RN_FP16_OUT_TOL,
                                        dx=RN_FP16_DX_TOL,
                                        stats=RN_FP16_STAT_TOL),
                         composed=[f["composed"] for f in f16],
                         collectives=[f["collectives"] for f in f16]),
               seconds=ranks_s, card=card)
    log(f"resnet_dp: two gloo ranks on one card (launcher, ResNet-50 fp32, "
        f"global batch {RN_RANK_B} at {RESNET_HW}x{RESNET_HW}, "
        f"{RN_RANK_B // 2} a rank, "
        f"eager DataParallel, Momentum(0.1, 0.9), {RN_RANK_STEPS} steps, "
        f"{ranks_s:.1f} s with start-up): losses {ranks[0]['losses']} vs "
        f"one process {single[0]} (batch reversed {flipped[0]}); distances "
        f"from one process {json.dumps(dist_of)}, bounds after step 1 "
        f"{json.dumps(bound)} (step {RN_RANK_STEPS} not held); collectives of rank 0 {json.dumps(ranks[0]['collectives'])} "
        f"[{card}]")
    log(f"resnet_dp: fp16 BatchNorm2D(64, act=relu) over the two ranks "
        f"(composed): error / max against one process {json.dumps(fp16_err)}"
        f", composed {[f['composed'] for f in f16]}, collectives "
        f"{[f['collectives'] for f in f16]} [{card}]")
    for rk in ranks:
        for k, st in rk["stats"].items():
            if st["plain"] or st["kernel"] != per_step.get(k, 0):
                raise AssertionError(f"resnet_dp: rank {rk['rank']} {k} "
                                     f"counters {st}, want "
                                     f"{per_step.get(k, 0)}")
        if any(rk["composed"].values()) or rk["collectives"].get(
                "bn_sync") != 2 * RESNET_BNS * RN_RANK_STEPS:
            raise AssertionError(f"resnet_dp: rank {rk['rank']}: composed "
                                 f"{rk['composed']}, collectives "
                                 f"{rk['collectives']}")
        if rk["losses"] != ranks[0]["losses"]:
            raise AssertionError(f"resnet_dp: the ranks' losses differ: "
                                 f"{[x['losses'] for x in ranks]}")
        f = rk["fp16"]
        if (f["composed"].get("fused_bn") != 1
                or f["collectives"].get("bn_sync") != 2
                or any(st["kernel"] or st["plain"] for name, st in
                       f["stats"].items() if name.startswith("fused_bn"))):
            raise AssertionError(f"resnet_dp: rank {rk['rank']}'s fp16 "
                                 f"layer: {f['composed']} "
                                 f"{f['collectives']} {f['stats']}")
    if any(dist_of["ranks"][k] > bound[k] for k in bound):
        raise AssertionError(f"resnet_dp: two ranks against one process: "
                             f"{dist_of} over {bound}")
    if (fp16_err["out"] > RN_FP16_OUT_TOL or fp16_err["dx"] > RN_FP16_DX_TOL
            or fp16_err["stats"] > RN_FP16_STAT_TOL):
        raise AssertionError(f"resnet_dp: the fp16 layer: {fp16_err}")
    free_card()
    return res


def rn_dp_phase(card):
    """Phase 27: ResNet-50 through DataParallel with synchronized batch
    norm: the world-1 nccl step captured against the plain one, then two
    gloo ranks on the card against one process."""
    t0 = time.perf_counter()
    res = dict(world1=rn_dp_world1(card))
    res["two_ranks"] = rn_dp_two_ranks(card)
    res["phase_s"] = time.perf_counter() - t0
    log(f"resnet_dp: phase 27 took {res['phase_s']:.1f} s [{card}]")
    return res


# ------------- phase 28: ZeRO sharding and the sharded checkpoint -------------

ZERO_LEVELS = ("os", "os_g", "p_g_os")
ZERO_STEPS = 3
#: the two gloo ranks' fp32 step held against one process: a multiple of
#: the one process's distance from itself with the batch reversed, plus a
#: floor (as phase 27)
ZERO_NOISE_MULT, ZERO_LOSS_FLOOR, ZERO_STATE_FLOOR = 4.0, 1e-5, 1e-5


def zero_model(cfg, dev, level, o2_eager=False):
    """GPT(cfg) and AdamW(1e-4, wd 0.01), through group_sharded_parallel at
    ``level`` (None: plain); ``o2_eager`` casts the parameters to bf16
    (amp.decorate O2) for the eager loop."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models.gpt import GPT
    net = GPT(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    if o2_eager:
        net = amp.decorate(net, level="O2", dtype="bfloat16")
    opt = optimizer.AdamW(learning_rate=DP_LR, parameters=net.parameters(),
                          weight_decay=0.01)
    if level is not None:
        topology.set_hybrid_communicate_group(None)
        net, opt, _ = group_sharded_parallel(net, opt, level)
    return net, opt


def zero_train_step(cfg, dev, level):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    net, opt = zero_model(cfg, dev, level)
    return TrainStep(net, F.cross_entropy, opt, amp_dtype=torch.bfloat16)


def zero_eager_run(cfg, dev, level, batches):
    """ZERO_STEPS eager O2 steps: (losses, {name: state tensor},
    collectives of the steps)."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.nn import functional as F
    net, opt = zero_model(cfg, dev, level, o2_eager=True)
    losses = []
    C.reset_launch_stats()
    for i in range(ZERO_STEPS):
        loss = F.cross_entropy(net(batches[i % 2][0]), batches[i % 2][1])
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach().float())
    coll = C.launch_stats()
    state = {f"param {k}": v.detach().clone()
             for k, v in net.state_dict().items()}
    state.update({f"opt {k}": v.clone() for k, v in opt.state_dict().items()
                  if isinstance(v, torch.Tensor)})
    return torch.stack(losses).cpu(), state, coll


def zero_world1(cfg, card):
    """World 1 over NCCL: GPT-2 small O2 bf16 b8 s1024 through
    group_sharded_parallel at each level, captured in TrainStep and in the
    eager loop, each bit for bit with its plain counterpart over
    ZERO_STEPS steps under deterministic_steps (losses, masters, slots,
    buffers), with the plain step's kernel launches; the captured steps
    timed in turns with their exact launches and collectives a step; then
    the stage-1 step saved asynchronously while it trains, and restored."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.ops import kernels
    dev = torch.device("cuda")
    dist.init_parallel_env()
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"zero: world {dist.get_backend()} "
                             f"{dist.get_world_size()}")
    rng = np.random.default_rng(0)
    batches = [tuple(torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        TRAIN_B, TRAIN_L))).to(dev) for _ in range(2)) for _ in range(2)]
    res = dict(card=card, steps=ZERO_STEPS)
    # 1. captured, bit for bit against the plain captured step
    runs = {}
    for level in (None,) + ZERO_LEVELS:
        torch.manual_seed(0)
        step = zero_train_step(cfg, dev, level)
        C.reset_launch_stats()
        kernels.reset_stats()
        losses = []
        with deterministic_steps():
            for i in range(ZERO_STEPS):
                losses.append(step(*batches[i % 2]))
            torch.cuda.synchronize()
        runs[level] = dict(losses=torch.stack(losses).cpu(),
                           state=step_state(step), stats=kernels.all_stats(),
                           collectives=C.launch_stats(),
                           graphs=graph_summary(step))
        step.release_graphs()
        del step
        free_card()
    plain = runs[None]
    want_launches = {k: v * ZERO_STEPS
                     for k, v in split_per_step(PER_STEP).items()}
    res["captured"] = {}
    for level in ZERO_LEVELS:
        r = runs[level]
        diff = [k for k, v in plain["state"].items()
                if not bits_equal(v, r["state"][k])]
        same = bits_equal(plain["losses"], r["losses"])
        launches = {k: v["kernel"] for k, v in r["stats"].items()
                    if v["kernel"]}
        plain_runs = {k: v["plain"] for k, v in r["stats"].items()
                      if v["plain"]}
        res["captured"][level] = dict(
            losses=r["losses"].tolist(), losses_bit_for_bit=same,
            state_tensors=len(plain["state"]), state_differing=diff,
            launches=launches, collectives=r["collectives"],
            graphs=r["graphs"])
        log(f"zero: TrainStep(group_sharded {level}) captured, GPT-2 small "
            f"O2 b{TRAIN_B} s{TRAIN_L}, world 1 over nccl, against the plain "
            f"captured step, {ZERO_STEPS} steps under deterministic_steps: "
            f"losses bit for bit {same}, {len(diff)} of "
            f"{len(plain['state'])} masters/slots/buffers differ; launches "
            f"{json.dumps(launches)}; collectives {json.dumps(r['collectives'])}"
            f" [{card}]")
        if (not same or diff or plain_runs or launches != want_launches
                or r["stats"] != plain["stats"]):
            raise AssertionError(f"zero: captured {level}: "
                                 f"{res['captured'][level]} {plain_runs}")
    del runs
    free_card()
    # 2. the eager O2 loop, bit for bit against the plain eager loop
    res["eager"] = {}
    with deterministic_steps():
        kernels.reset_stats()
        want_l, want_s, _ = zero_eager_run(cfg, dev, None, batches)
        want_stats = kernels.all_stats()
        for level in ZERO_LEVELS:
            kernels.reset_stats()
            got_l, got_s, coll = zero_eager_run(cfg, dev, level, batches)
            stats = kernels.all_stats()
            diff = [k for k, v in want_s.items()
                    if k not in got_s or not bits_equal(v, got_s[k])]
            same = bits_equal(want_l, got_l)
            res["eager"][level] = dict(losses=got_l.tolist(),
                                       losses_bit_for_bit=same,
                                       state_differing=diff,
                                       collectives=coll)
            log(f"zero: eager O2 loop (group_sharded {level}) against the "
                f"plain eager loop, {ZERO_STEPS} steps: losses bit for bit "
                f"{same}, {len(diff)} of {len(want_s)} parameters/slots "
                f"differ; collectives {json.dumps(coll)} [{card}]")
            if not same or diff or stats != want_stats or any(
                    v["plain"] for v in stats.values()):
                worst = {k: float((got_s[k].double() - want_s[k].double())
                                  .abs().max()) for k in diff[:4]
                         if k in got_s}
                raise AssertionError(
                    f"zero: eager {level}: losses {got_l.tolist()} against "
                    f"the plain loop's {want_l.tolist()}; {len(diff)} "
                    f"tensors differ, e.g. {worst}; launches {stats} "
                    f"against {want_stats}")
            free_card()
    # 3. the captured steps timed in turns, with their exact launches
    steps = {str(level): zero_train_step(cfg, dev, level)
             for level in (None,) + ZERO_LEVELS}
    for st in steps.values():
        for _ in range(2):
            st(*batches[0])
    ms = {name: [] for name in steps}
    for _ in range(CAPTURE_ROUNDS):
        for name, st in steps.items():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(ZERO_STEPS):
                st(*batches[0])
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t1) * 1e3 / ZERO_STEPS)
    per_step, exact, launches = {}, {}, {}
    for name, st in steps.items():
        kernels.reset_stats()
        C.reset_launch_stats()
        for _ in range(ZERO_STEPS):
            st(*batches[0])
        torch.cuda.synchronize()
        stats = kernels.all_stats()
        exact_launches(f"zero {name}", stats, PER_STEP, ZERO_STEPS)
        if name != "None":  # the ZeRO path's launches, its three levels
            for k, v in stats.items():
                acc = launches.setdefault(k, {"kernel": 0, "plain": 0})
                acc["kernel"] += v["kernel"]
                acc["plain"] += v["plain"]
        per_step[name] = {k: v / ZERO_STEPS
                          for k, v in C.launch_stats().items()}
        exact[name] = {k: v["kernel"] // ZERO_STEPS
                       for k, v in kernels.all_stats().items()
                       if v["kernel"]}
    busy = {name: device_ops(lambda: st(*batches[0]))[1]
            for name, st in steps.items()}
    tokens = TRAIN_B * TRAIN_L
    res["launches"] = launches
    res["timed"] = dict(step_ms=ms, device_busy_ms=busy,
                        launches_per_step=exact,
                        collectives_per_step=per_step,
                        tokens_per_s={n: tokens / (min(v) / 1e3)
                                      for n, v in ms.items()})
    log(f"zero: GPT-2 small O2 b{TRAIN_B} s{TRAIN_L} captured, step ms in "
        f"turns (runs of {ZERO_STEPS}): {json.dumps(ms)}; device busy a "
        f"step {json.dumps(busy)}; tokens/s (best run) "
        f"{json.dumps(res['timed']['tokens_per_s'])}; launches a step "
        f"{json.dumps(exact)}; collectives a step {json.dumps(per_step)} "
        f"[{card}]")
    for level in ZERO_LEVELS:
        c = per_step[level]
        if not (c.get("reduce_scatter", 0) >= 1 and c.get("all_gather", 0)
                == c.get("reduce_scatter") and c.get("all_reduce") == 2):
            raise AssertionError(f"zero: collectives a step {per_step}")
    res["checkpoint"] = zero_async_ckpt(steps["os"], batches, card)
    for st in steps.values():
        st.release_graphs()
    del steps, st
    free_card()
    res["health"] = zero_health(cfg, dev, batches, card)
    return res


def zero_health(cfg, dev, batches, card):
    """The sentinel on the captured stage-3 step at interval 1 against the
    plain step's, under deterministic_steps: the same readings at world 1
    (the shards' squared sums all-reduced in fp64 inside the graph)."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    got = {}
    with env_var("PADDLE_TPU_HEALTH_INTERVAL", "1"), deterministic_steps():
        for level in (None, "p_g_os"):
            net, opt = zero_model(cfg, dev, level)
            step = TrainStep(net, F.cross_entropy, opt,
                             amp_dtype=torch.bfloat16, health=True)
            C.reset_launch_stats()
            for i in range(ZERO_STEPS):
                step(*batches[i % 2])
            h = step.last_health
            got[str(level)] = dict(
                stats={k: h[k] for k in ("loss", "grad_norm", "param_norm",
                                         "update_ratio", "nonfinite")},
                collectives=C.launch_stats(), graphs=graph_summary(step))
            step.release_graphs()
            del step, net, opt
            free_card()
    same = got["None"]["stats"] == got["p_g_os"]["stats"]
    log(f"zero: the sentinel at interval 1 on the captured p_g_os step "
        f"against the plain step's, {ZERO_STEPS} steps: the same readings "
        f"{same} ({json.dumps(got['p_g_os']['stats'])}); collectives "
        f"{json.dumps(got['p_g_os']['collectives'])} [{card}]")
    if not same or got["p_g_os"]["collectives"].get("health") != \
            2 * ZERO_STEPS:
        raise AssertionError(f"zero: health: {got}")
    return got


def _tree_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def zero_async_ckpt(step, batches, card):
    """The captured stage-1 step saved asynchronously while it trains:
    the synchronous snapshot's ms (the step's critical path), the
    background write's seconds and bytes, the step ms while the writer
    runs against without it; then the step restored from the directory,
    bit for bit with the state at the save, and the restore's seconds."""
    import shutil
    import tempfile
    from paddle_tpu_torch.distributed import sharded_checkpoint as sc
    from paddle_tpu_torch.profiler import metrics
    d = tempfile.mkdtemp(prefix="zero_ckpt_", dir=os.path.abspath(OUT_DIR))
    hist = metrics.default_registry().get("checkpoint_async_seconds")

    def hist_sum():
        return sum(v["sum"] for v in hist.snapshot()["values"]) \
            if hist is not None else float("nan")

    mgr = sc.ShardedCheckpointManager(d, async_save=True, keep_last_n=2)
    n = 2 * ZERO_STEPS

    def run_ms():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n):
            step(*batches[0])
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3 / n

    quiet = [run_ms()]
    torch.cuda.synchronize()
    before = step_state(step)
    saved_at = step._t
    w0 = hist_sum()
    t1 = time.perf_counter()
    mgr.save(step.sharded_state(), saved_at)
    snap_ms = (time.perf_counter() - t1) * 1e3
    busy_at_start = mgr._writer.busy()
    during = [run_ms()]
    busy_after = mgr._writer.busy()
    mgr.drain()
    write_s = hist_sum() - w0
    quiet.append(run_ms())
    # a second save: the host's pinned blocks of the first are reused
    t1 = time.perf_counter()
    mgr.save(step.sharded_state(), step._t)
    snap2_ms = (time.perf_counter() - t1) * 1e3
    mgr.drain()
    path = mgr.path_for(saved_at)
    status = sc.verify_step(path, deep=True)[0]
    nbytes = _tree_bytes(path)
    t1 = time.perf_counter()
    state = sc.load_step(path, mesh=step._group)
    step.set_sharded_state(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    after = step_state(step)
    diff = [k for k, v in before.items() if not bits_equal(v, after[k])]
    del after
    step(*batches[0])  # the restored step replays its graph
    res = dict(snapshot_ms=snap_ms, second_snapshot_ms=snap2_ms,
               write_s=write_s, bytes=nbytes,
               step_ms_quiet=quiet, step_ms_writing=during,
               writer_busy=[busy_at_start, busy_after], status=status,
               restore_s=restore_s, restored_differing=diff)
    log(f"zero: async sharded save of the captured stage-1 step: snapshot "
        f"{snap_ms:.1f} ms on the step's path (a second save's "
        f"{snap2_ms:.1f} ms), background write "
        f"{write_s:.2f} s, {nbytes / 2 ** 20:.1f} MiB, {status}; step ms "
        f"while writing {during} (writer busy at start/end "
        f"{[busy_at_start, busy_after]}) vs quiet {quiet}; restore "
        f"{restore_s:.2f} s, {len(diff)} of {len(before)} tensors differ "
        f"from the state at the save [{card}]")
    shutil.rmtree(d, ignore_errors=True)
    if diff or status != "complete":
        raise AssertionError(f"zero: async checkpoint: {res}")
    return res


def _hashes(tensors: dict) -> dict:
    """{name: sha256 of the tensor's bytes}."""
    import hashlib
    out = {}
    for k, v in tensors.items():
        if isinstance(v, torch.Tensor):
            b = v.detach().cpu().contiguous().view(torch.uint8).numpy()
            out[k] = hashlib.sha256(b.tobytes()).hexdigest()
    return out


def zero_gathered_hashes(net, opt):
    """Hashes of the whole state every rank gathers: parameters and the
    optimizer's slots."""
    sd = {f"param {k}": v for k, v in net.state_dict().items()}
    sd.update({f"opt {k}": v for k, v in opt.state_dict().items()})
    return _hashes(sd)


def zero_ckpt_state(net, opt):
    return {"model": {k: v.detach() for k, v in net.state_dict().items()},
            "opt": opt.sharded_state_dict()}


def zero_fp32_step(net, opt, ids, labels):
    from paddle_tpu_torch.nn import functional as F
    loss = F.cross_entropy(net(ids), labels)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.detach())


def zero_rank_worker(outdir):
    """One rank of phase 28's two-rank gloo run (started by the launcher):
    GPT-2 small fp32 at each level, one eager step on its rows of the
    global batch 8 x 1024; its slot and parameter bytes; its distance from
    the one-process step; then the world-1 checkpoint ``ck1`` restored
    onto the two ranks, and a stage-1 step saved into ``ck2`` through the
    coordinator."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.models.gpt import GPTConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    r = dist.get_rank()
    dev = dist.parallel.rank_device()
    cfg = GPTConfig.gpt2_small()
    cfg.dropout = cfg.attn_dropout = 0.0
    ids, labels = (dist.shard_batch(t).to(dev) for t in dp_rank_batch(cfg))
    single = torch.load(os.path.join(outdir, "single.pt"),
                        weights_only=False)
    out = dict(rank=r, backend=dist.get_backend(), device=str(dev),
               levels={})
    for level in ZERO_LEVELS:
        kernels.reset_stats()
        net, opt = zero_model(cfg, dev, level)
        t0 = time.perf_counter()
        loss = zero_fp32_step(net, opt, ids, labels)
        secs = time.perf_counter() - t0
        whole = sum(p.numel() for p in single["params"].values())
        slot_elems = sum(v.numel() for d in opt._opt._slots.values()
                         for v in d.values())
        rest = sum(p.numel() for p in net.parameters())
        free_card()
        allocated = torch.cuda.memory_allocated(dev)
        params = {k: v.detach() for k, v in net.state_dict().items()}
        out["levels"][level] = dict(
            loss=loss, seconds=secs, params_dist=rel_l2_all(
                {k: v.cpu() for k, v in params.items()}, single["params"]),
            slot_elems=slot_elems, whole_slot_elems=2 * whole,
            param_elems_at_rest=rest, whole_param_elems=whole,
            memory_allocated=allocated, stats=kernels.all_stats())
        del net, opt, params
        free_card()
    # the world-1 step's checkpoint restored onto the two ranks
    net, opt = zero_model(cfg, dev, "os")
    mgr = ckpt.open_manager(os.path.join(outdir, "ck1"), layout="sharded",
                            mesh=opt.group)
    t0 = time.perf_counter()
    state, step = mgr.load_latest()
    net.load_state_dict(state["model"])
    opt.set_state_dict(state["opt"])
    out["restore_s"] = time.perf_counter() - t0
    with open(os.path.join(outdir, "ck1.json")) as f:
        want = json.load(f)
    got = zero_gathered_hashes(net, opt)
    out["restored_differing"] = sorted(k for k in want
                                       if got.get(k) != want[k])
    del net, opt, state
    free_card()
    # a stage-1 step of the two ranks, saved through the coordinator
    net, opt = zero_model(cfg, dev, "os")
    zero_fp32_step(net, opt, ids, labels)
    hashes = zero_gathered_hashes(net, opt)
    mgr = ckpt.open_manager(os.path.join(outdir, "ck2"), layout="sharded",
                            coordinator=ckpt.coordinator_from_env(
                                timeout=120))
    t0 = time.perf_counter()
    out["committed"] = mgr.save(zero_ckpt_state(net, opt), 1)
    out["save_s"] = time.perf_counter() - t0
    if r == 0:
        with open(os.path.join(outdir, "ck2.json"), "w") as f:
            json.dump(hashes, f)
    torch.save(out, os.path.join(outdir, f"rank{r}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def zero_two_ranks(card):
    """Two gloo ranks on the one card (the launcher) at each level: the
    loss and parameters after one fp32 step within ZERO_NOISE_MULT times
    one process's distance from itself with the batch reversed (plus a
    floor); each rank's slots half the whole and at stage 3 its
    parameters too; the checkpoints of one world restored onto the other,
    bit for bit with the state gathered before the save."""
    import shutil
    import signal
    import tempfile
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.models.gpt import GPTConfig
    cfg = GPTConfig.gpt2_small()
    cfg.dropout = cfg.attn_dropout = 0.0
    dev = torch.device("cuda")
    out = tempfile.mkdtemp(prefix="zero_ranks_", dir=os.path.abspath(OUT_DIR))
    torch.backends.cuda.matmul.allow_tf32 = False
    # one process: the global batch and the batch reversed; a stage-1 step
    # of world 1 saved into ck1
    dist.init_parallel_env()
    ids, labels = (t.to(dev) for t in dp_rank_batch(cfg))
    single = {}
    for name, (x, y) in (("single", (ids, labels)),
                         ("reversed", (ids.flip(0), labels.flip(0)))):
        net, opt = zero_model(cfg, dev, None)
        loss = zero_fp32_step(net, opt, x, y)
        single[name] = dict(loss=loss, params={
            k: v.detach().cpu() for k, v in net.state_dict().items()})
        del net, opt
        free_card()
    torch.save(single["single"], os.path.join(out, "single.pt"))
    noise = dict(loss=rel(single["reversed"]["loss"],
                          single["single"]["loss"]),
                 params=rel_l2_all(single["reversed"]["params"],
                                   single["single"]["params"]))
    bound = dict(loss=ZERO_NOISE_MULT * noise["loss"] + ZERO_LOSS_FLOOR,
                 params=ZERO_NOISE_MULT * noise["params"]
                 + ZERO_STATE_FLOOR)
    net, opt = zero_model(cfg, dev, "os")
    zero_fp32_step(net, opt, ids, labels)
    with open(os.path.join(out, "ck1.json"), "w") as f:
        json.dump(zero_gathered_hashes(net, opt), f)
    t0 = time.perf_counter()
    ckpt.open_manager(os.path.join(out, "ck1"), layout="sharded").save(
        zero_ckpt_state(net, opt), 1)
    save1_s = time.perf_counter() - t0
    del net, opt
    free_card()
    dist.destroy_process_group()
    env = dict(os.environ, PADDLE_DISTRI_BACKEND="gloo")
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ENDPOINTS", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--log_dir", os.path.join(out, "log"),
         os.path.abspath(__file__), "--zero-worker", out],
        env=env, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=400)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        raise AssertionError(f"zero: the two ranks did not end within 400 s:"
                             f"\n{text[-3000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(30)
    ranks_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"zero: the launcher exited {proc.returncode}:"
                             f"\n{text[-4000:]}")
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    # the two ranks' checkpoint restored onto one process
    dist.init_parallel_env()
    net, opt = zero_model(cfg, dev, "os")
    t0 = time.perf_counter()
    state, _ = ckpt.open_manager(os.path.join(out, "ck2"), layout="sharded",
                                 mesh=opt.group).load_latest()
    net.load_state_dict(state["model"])
    opt.set_state_dict(state["opt"])
    restore2_s = time.perf_counter() - t0
    with open(os.path.join(out, "ck2.json")) as f:
        want = json.load(f)
    got = zero_gathered_hashes(net, opt)
    ck2_diff = sorted(k for k in want if got.get(k) != want[k])
    ck2_files = sorted(os.listdir(os.path.join(out, "ck2", "ckpt_1")))
    del net, opt, state
    free_card()
    dist.destroy_process_group()
    shutil.rmtree(out, ignore_errors=True)
    lv = {level: dict(
        losses=[rk["levels"][level]["loss"] for rk in ranks],
        loss_dist=rel(ranks[0]["levels"][level]["loss"],
                      single["single"]["loss"]),
        params_dist=ranks[0]["levels"][level]["params_dist"],
        slot_fraction=[rk["levels"][level]["slot_elems"]
                       / rk["levels"][level]["whole_slot_elems"]
                       for rk in ranks],
        param_fraction_at_rest=[rk["levels"][level]["param_elems_at_rest"]
                                / rk["levels"][level]["whole_param_elems"]
                                for rk in ranks],
        memory_allocated_mib=[rk["levels"][level]["memory_allocated"]
                              / 2 ** 20 for rk in ranks],
        seconds=[rk["levels"][level]["seconds"] for rk in ranks])
        for level in ZERO_LEVELS}
    res = dict(levels=lv, noise=noise, bound=bound,
               single_loss=single["single"]["loss"],
               ck1=dict(save_s=save1_s,
                        restore_s=[rk["restore_s"] for rk in ranks],
                        differing=[rk["restored_differing"]
                                   for rk in ranks]),
               ck2=dict(committed=[rk["committed"] for rk in ranks],
                        save_s=[rk["save_s"] for rk in ranks],
                        restore_s=restore2_s, differing=ck2_diff,
                        manifests=[f for f in ck2_files
                                   if f.startswith("manifest")]),
               launches_by_rank={level: [rk["levels"][level]["stats"]
                                         for rk in ranks]
                                 for level in ZERO_LEVELS},
               launches={k: {"kernel": sum(rk["levels"][lv_]["stats"][k][
                   "kernel"] for rk in ranks for lv_ in ZERO_LEVELS),
                   "plain": sum(rk["levels"][lv_]["stats"][k]["plain"]
                                for rk in ranks for lv_ in ZERO_LEVELS)}
                   for k in ranks[0]["levels"]["os"]["stats"]},
               seconds=ranks_s, card=card)
    log(f"zero: two gloo ranks on one card (launcher, GPT-2 small fp32, b4 a "
        f"rank x s{TRAIN_L}, one eager AdamW step a level, "
        f"{ranks_s:.1f} s with start-up): {json.dumps(lv)}; one process "
        f"loss {single['single']['loss']}, its distance from itself with "
        f"the batch reversed {json.dumps(noise)}, bounds {json.dumps(bound)}"
        f" [{card}]")
    log(f"zero: sharded checkpoint across worlds: world 1 -> 2 ranks "
        f"{json.dumps(res['ck1'])}; 2 ranks (coordinated) -> world 1 "
        f"{json.dumps(res['ck2'])} [{card}]")
    for level, d in lv.items():
        stats = res["launches_by_rank"][level]
        if (d["loss_dist"] > bound["loss"] or d["params_dist"] > bound["params"]
                or d["losses"][0] != d["losses"][1]
                or d["slot_fraction"] != [0.5, 0.5]
                or d["param_fraction_at_rest"] != (
                    [0.5, 0.5] if level == "p_g_os" else [1.0, 1.0])
                or any(st["plain"] for s in stats for st in s.values())
                or not all(any(st["kernel"] for st in s.values())
                           for s in stats)):
            raise AssertionError(f"zero: two ranks at {level}: {d} {stats}")
    if (any(res["ck1"]["differing"]) or ck2_diff
            or res["ck2"]["committed"] != [True, True]):
        raise AssertionError(f"zero: checkpoints across worlds: {res}")
    return res


def zero_phase(cfg, card):
    """Phase 28: ZeRO at its three levels on a world-1 nccl group
    (captured and eager, bit for bit with the plain steps, timed; the
    asynchronous sharded save), then two gloo ranks on the card with the
    checkpoint restored across world sizes."""
    t0 = time.perf_counter()
    res = dict(world1=zero_world1(cfg, card))
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import topology
    topology.set_hybrid_communicate_group(None)
    dist.destroy_process_group()
    res["two_ranks"] = zero_two_ranks(card)
    res["phase_s"] = time.perf_counter() - t0
    log(f"zero: phase 28 took {res['phase_s']:.1f} s [{card}]")
    return res


def fp32_row(kname, rows, paths):
    """For the 1x1 conv's entry: its fp32 row at the main shape, with its
    launches on phase 22's fp32 path, as `fp32`."""
    if kname != "conv1x1_stats":
        return {}
    shape = KERNELS[kname]["main"][1]
    r = next(r for r in rows if r["kernel"] == kname
             and r["dtype"] == "float32" and r["shape"] == shape)
    return {"fp32": dict(
        shape=f"{r['shape']} float32", design=r["design"],
        launches=paths["resnet_fit"]["launches"][kname]["kernel"],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        bound_cuda_core_ms=r["bound_cuda_core_ms"],
        library_ms=r["library_ms"])}


KERNELS = {
    "layer_norm": dict(source="paddle_tpu_torch/csrc/layer_norm.cu",
                       replaces="paddle_tpu/ops/pallas/layer_norm.py:44",
                       main=("float32", "R=1024 N=768")),
    # the custom vjp's backward, which XLA fuses on the TPU; its main row
    # is the driving path's, BERT-Base's B 256 x L 128 under O2
    "layer_norm_bwd": dict(
        source="paddle_tpu_torch/csrc/layer_norm.cu",
        replaces="paddle_tpu/ops/pallas/layer_norm.py:193",
        main=("bfloat16", "R=32768 N=768 eps=1e-12")),
    "flash_attention": dict(
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:804",
        main=("float32", "B=1 L=1024 H=12 D=64 causal")),
    "flash_attention_bwd": dict(
        source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:960",
        main=("bfloat16", "B=8 L=1024 H=12 D=64 causal")),
    "paged_attention": dict(
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/ops/pallas/paged_attention.py:162",
        main=("float32", "W=32")),
    "softmax_ce_fwd": dict(
        source="paddle_tpu_torch/csrc/softmax_ce.cu",
        replaces="paddle_tpu/ops/pallas/softmax_ce.py:194",
        main=("bfloat16", "N=8192 V=50304")),
    "softmax_ce_bwd": dict(
        source="paddle_tpu_torch/csrc/softmax_ce.cu",
        replaces="paddle_tpu/ops/pallas/softmax_ce.py:233",
        main=("bfloat16", "N=8192 V=50304")),
    "fused_bn_fwd": dict(
        source="paddle_tpu_torch/csrc/fused_bn.cu",
        replaces="paddle_tpu/ops/pallas/fused_bn.py:93",
        main=("bfloat16", "R=1605632 C=64 add=False")),
    "fused_bn_bwd_reduce": dict(
        source="paddle_tpu_torch/csrc/fused_bn.cu",
        replaces="paddle_tpu/ops/pallas/fused_bn.py:150",
        main=("bfloat16", "R=1605632 C=64 add=False")),
    "fused_bn_bwd_dx": dict(
        source="paddle_tpu_torch/csrc/fused_bn.cu",
        replaces="paddle_tpu/ops/pallas/fused_bn.py:189",
        main=("bfloat16", "R=1605632 C=64 add=False")),
    "conv1x1_stats": dict(
        source="paddle_tpu_torch/csrc/fused_conv_bn.cu",
        replaces="paddle_tpu/ops/pallas/fused_conv_bn.py:103",
        main=("bfloat16", "R=100352 Cin=512 Cout=128")),
    "flash_attention_bwd_dq": dict(
        source="paddle_tpu_torch/csrc/flash_attention_bwd_split.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:1047",
        main=("bfloat16", f"B=1 L={LONG_L} H={LONG_H} D={LONG_D} causal")),
    "flash_attention_bwd_dkv": dict(
        source="paddle_tpu_torch/csrc/flash_attention_bwd_split.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:1071",
        main=("bfloat16", f"B=1 L={LONG_L} H={LONG_H} D={LONG_D} causal")),
    # the same kernels with the bool-mask operand (counted apart), on
    # phase 21's path: the encoder's self-attention is the main row (the
    # reference's small path: L 128 <= 512)
    "flash_attention_masked": dict(
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:533",
        main=("bfloat16", f"B={TB_B} Lq={TB_LS} Lk={TB_LS} H={TB_H} "
                          f"D={TB_D} pad")),
    "flash_attention_bwd_masked": dict(
        source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:566",
        main=("bfloat16", f"B={TB_B} Lq={TB_LS} Lk={TB_LS} H={TB_H} "
                          f"D={TB_D} pad")),
}


def split_masked(kname, rows, paths):
    """For the split pair's entries: its masked row (phase 3 only; no
    main path sends a sequence past the one-pass gate with a mask) as
    `masked`, with its launches on the main paths (`paths`: {path: its
    result, with its run's launches})."""
    if kname not in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        return {}
    r = next(r for r in rows if r["kernel"] == MASKED[kname])
    launches = sum(res["launches"][MASKED[kname]]["kernel"]
                   for res in paths.values())
    return {"masked": dict(
        shape=f"{r['shape']} {r['dtype']}", design=r["design"],
        launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"])}

#: the phases `--phases` may name, in the order they run
PHASES = ("serve", "health", "health_trip", "fit_resume", "transformer",
          "resnet_fit", "serve_control", "observe", "ps", "dp", "resnet_dp",
          "zero")


def only_phases(phases, cfg, smi, name):
    """Run the named phases of PHASES alone (after the device and build
    phases; "serve" is phase 4 with its CPU cross-check, phase 5);
    health_trip needs health's step."""
    res = {}
    if "serve" in phases:
        from paddle_tpu_torch.models.gpt import GPT
        model = GPT(cfg, device="cuda",
                    generator=torch.Generator().manual_seed(0))
        model.eval()
        res["serve"], prompts = serve(model, cfg, smi)
        res["cpu_cross_check"] = cross_check(model, cfg, prompts)
        del model
        free_card()
    if "health" in phases:
        res["health"], tripped, batch = health_train(cfg, smi)
        if "health_trip" in phases:
            res["health_trip"] = health_trip(tripped, batch, smi)
        del tripped, batch
        torch.cuda.empty_cache()
    if "fit_resume" in phases:
        res["fit_resume"] = fit_resume(cfg, smi)
    if "transformer" in phases:
        res["transformer"] = transformer_train(smi)
        res["transformer_cpu_cross_check"] = transformer_cross_check()
    if "resnet_fit" in phases:
        res["resnet_fit"] = resnet_fit(smi)
    if "serve_control" in phases:
        res["serve_control"] = serve_control(cfg, smi)
    if "observe" in phases:
        res["observe"] = observe(cfg, smi)
    if "ps" in phases:
        res["ps"] = ps_train(smi)
    if "dp" in phases:
        res["dp"] = dp_phase(cfg, smi)
    if "resnet_dp" in phases:
        res["resnet_dp"] = rn_dp_phase(smi)
    if "zero" in phases:
        res["zero"] = zero_phase(cfg, smi)
    with open(os.path.join(OUT_DIR, "chip_smoke_phases.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(smi)
    print(json.dumps({"ok": True, "phases": sorted(res), "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--phases", default=None,
                    help="comma-separated names of " + ", ".join(PHASES)
                    + ": run only those after the device and build phases")
    ap.add_argument("--dp-worker", default=None, metavar="DIR",
                    help="run one rank of phase 26's two-rank run (the "
                         "phase starts these through the launcher)")
    ap.add_argument("--rn-worker", default=None, metavar="DIR",
                    help="run one rank of phase 27's two-rank run")
    ap.add_argument("--zero-worker", default=None, metavar="DIR",
                    help="run one rank of phase 28's two-rank run")
    args = ap.parse_args(argv)
    if args.dp_worker is not None:
        dp_rank_worker(args.dp_worker)
        return 0
    if args.rn_worker is not None:
        rn_rank_worker(args.rn_worker)
        return 0
    if args.zero_worker is not None:
        zero_rank_worker(args.zero_worker)
        return 0
    phases = None
    if args.phases is not None:
        phases = set(args.phases.split(","))
        if not phases <= set(PHASES) or (
                "health_trip" in phases and "health" not in phases):
            ap.error(f"--phases: names of {PHASES}; health_trip needs "
                     f"health")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    from paddle_tpu_torch import _native
    from paddle_tpu_torch._platform import require_hopper
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    os.makedirs(OUT_DIR, exist_ok=True)

    # 1. device
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {name}, capability {cap}, {torch.cuda.device_count()} "
        f"card(s); torch {torch.__version__} CUDA {torch.version.cuda}")
    log(f"device: nvidia-smi {smi}")
    require_hopper(dev)

    # 2. build
    t0 = time.perf_counter()
    _native.load()
    log(f"build: kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_native.last_build_seconds:.2f} s)")
    if phases is not None:
        cfg = GPTConfig.gpt2_small()
        cfg.dropout = cfg.attn_dropout = 0.0
        return only_phases(phases, cfg, smi, name)

    # 3. kernels against their plain versions: serving shapes, the GPT
    # training step's (b8 s1024 bf16), the ResNet-50 step's (b128 224) and
    # the long path's (b1 s32768)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = (check_layer_norm(dev, gen, (32, 1024, TRAIN_B * TRAIN_L), 768)
            + check_flash(dev, gen, (64, 512, 1024), 12, 64)
            # serving's other prefill buckets, fp32 (on the TF32 tensor
            # cores), and off-bucket, long and D 128 witnesses
            + check_flash(dev, gen, (16, 32, 128, 256, 1000, 4096), 12, 64,
                          dtypes=(torch.float32,))
            + check_flash(dev, gen, (4096,), 16, 128,
                          dtypes=(torch.float32,))
            # the training step's: bf16 under O2, fp32 under Model.fit
            + check_flash(dev, gen, (TRAIN_L,), 12, 64, B=TRAIN_B)
            + check_flash(dev, gen, (1000, 4096), 12, 64,
                          dtypes=(torch.bfloat16,))
            + check_flash(dev, gen, (4096,), 16, 128,
                          dtypes=(torch.bfloat16,))
            + check_paged(dev, gen, 32, 12, 64, 16, 1024)
            + check_flash_bwd(dev, gen, (128, 512, TRAIN_L), TRAIN_B, 12, 64)
            + check_flash_bwd(dev, gen, (TRAIN_L,), 2, 16, 128,
                              dtypes=(torch.bfloat16,))
            + check_ce(dev, gen, TRAIN_B * TRAIN_L, 50304)
            # the ResNet step's loss (fp32 under Model.fit)
            + check_ce(dev, gen, RESNET_B, 1000)
            # the serving canary's (phase 23): B 2 x T 128 probe, fp32
            + check_ce(dev, gen, CONTROL_PROBE[0] * (CONTROL_PROBE[1] - 1),
                       50304, dtypes=(torch.float32,))
            + check_fused_bn(dev, gen, ((128, 112, 112, 64),
                                        (128, 14, 14, 1024)))
            + check_conv1x1(dev, gen, tuple(RESNET_CONV_SHAPES))
            + check_layer_norm(dev, gen, (LONG_L,), 768)
            + check_ce(dev, gen, LONG_L, 50304, iters=1)
            + check_flash_long(dev, gen)
            + check_flash_bwd_split(dev, gen)
            # the BERT step's (B 256 L 128, non-causal; the 2-way head; the
            # embeddings' eps 1e-12) and ERNIE's MLM loss (B 32, V 40,000)
            + check_flash(dev, gen, (BERT_L,), 12, 64, B=BERT_B,
                          causal=False)
            + check_flash_bwd(dev, gen, (BERT_L,), BERT_B, 12, 64,
                              causal=False)
            + check_ce(dev, gen, BERT_B, 2, dtypes=(torch.bfloat16,))
            + check_ce(dev, gen, ERNIE_B * BERT_L, 40000,
                       dtypes=(torch.bfloat16,))
            # Transformer-base's loss over its B 32 x 112 target tokens, in
            # the type phase 21's step hands the CE (TB_CE_DTYPE)
            + check_ce(dev, gen, TB_B * TB_LT, TB_VOCAB,
                       dtypes=(TB_CE_DTYPE,))
            + check_layer_norm(dev, gen, (BERT_B * BERT_L,), 768, eps=1e-12,
                               dtypes=(torch.bfloat16,))
            # Transformer-base's encoder rows (B 32 x 128, d_model 512)
            + check_layer_norm(dev, gen, (TB_B * TB_LS,), 512,
                               dtypes=(torch.bfloat16,))
            # the backward at the paths' shapes: GPT O2 and Model.fit,
            # BERT (eps 1e-12) and the long path, Transformer-base
            + check_layer_norm_bwd(dev, gen, TRAIN_B * TRAIN_L, 768,
                                   torch.bfloat16)
            + check_layer_norm_bwd(dev, gen, TRAIN_B * TRAIN_L, 768,
                                   torch.float32)
            + check_layer_norm_bwd(dev, gen, BERT_B * BERT_L, 768,
                                   torch.bfloat16, eps=1e-12)
            + check_layer_norm_bwd(dev, gen, LONG_L, 768, torch.bfloat16)
            + check_layer_norm_bwd(dev, gen, TB_B * TB_LS, 512,
                                   torch.bfloat16))
    # the bool-mask operand: phase 21's attention shapes, and the split
    # pair at the long path's length
    masked_rows, masked_split = check_flash_masked(dev, gen)
    rows += masked_rows + check_split_masked(dev, gen)
    # the floor of any launch: a row whose bound lies below it is stated
    # at the floor too (bound_with_floor_ms), beside its bound
    floor = launch_floor_ms()
    log(f"kernels: an empty kernel takes {floor:.4f} ms from a replayed "
        f"graph [{smi}]")
    for r in rows:
        r.setdefault("tol_ratio", r["max_abs_err"] / r.get("tol", 1.0))
        r.setdefault("design", "cuda-core")
        if r["bound_ms"] < floor:
            r["bound_with_floor_ms"] = floor
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        extra = ""
        if "plain_shape" in r:
            extra += f"; plain at {r['plain_shape']}"
        if r.get("one_pass_ms") is not None:
            extra += f"; one-pass kernel_ms {r['one_pass_ms']:.4f}"
        if r.get("split_ms") is not None:
            extra += f"; split pair kernel_ms {r['split_ms']:.4f}"
        for wname, wr in r.get("witnesses", {}).items():
            extra += f"; against the {wname} /tol {wr:.3f}"
        if "bound_cuda_core_ms" in r:
            extra += f"; CUDA-core bound_ms {r['bound_cuda_core_ms']:.4f}"
        if "bound_with_floor_ms" in r:
            extra += (f"; with the launch floor bound_ms "
                      f"{r['bound_with_floor_ms']:.4f}")
        log(f"kernel {r['kernel']:<19} {r['dtype']:<8} "
            f"{r['shape']:<30} {r['design']:<9} err "
            f"{r['max_abs_err']:.2e} (/tol {r['tol_ratio']:.3f})  kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {lib} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}){extra} [{smi}]")
    bad = [r for r in rows if not all(
        x <= 1.0 for x in (r["tol_ratio"], *r.get("witnesses", {}).values()))]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    edges = {**check_edges(dev, gen), **check_resnet_edges(dev, gen),
             **check_split_edges(dev, gen)}
    for part in (masked_split, check_masked_edges(dev, gen)):
        for kname, ratio in part.items():
            edges[kname] = max(edges.get(kname, 0.0), ratio)
    log("edges: worst error / tolerance " + ", ".join(
        f"{k} {v:.3f}" for k, v in edges.items()))
    if not all(v <= 1.0 for v in edges.values()):
        raise AssertionError(f"kernels disagree at their edges: {edges}")

    # 4. serve GPT-2 small at full width, eager and fused in paired rounds
    cfg = GPTConfig.gpt2_small()
    cfg.dropout = cfg.attn_dropout = 0.0
    model = GPT(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    model.eval()
    served, prompts = serve(model, cfg, smi)
    # 5. cross-check on the CPU
    cpu_res = cross_check(model, cfg, prompts)
    del model
    torch.cuda.empty_cache()
    # 6. train GPT-2 small at full width, O2 bf16, b8 s1024
    trained = train(cfg, smi)
    # 6b. the captured step's edges: a failing capture, remat and dropout
    cap_edges = capture_edges(smi)
    # 7. training cross-check on the CPU
    train_cpu = train_cross_check(cfg)
    # 8. train ResNet-50 NHWC, O2 bf16, b128 224x224
    resnet = resnet_train(smi, dev)
    for r in rows:  # the 1x1 rows' launches a step at their shape
        if r["kernel"] == "conv1x1_stats" and r["dtype"] == "bfloat16":
            r["launches_per_step"] = resnet["conv1x1_shapes"].get(
                r["shape"], 0)
    # 9. its cross-check on the CPU, at the size of the CPU tests and at one
    # where layer4's batch norms see 128 rows
    resnet_cpu = [resnet_cross_check(dev, B, hw)
                  for B, hw in ((2, 64), (8, 128))]
    # 10. train GPT-2 small on one 32,768-token sequence, remat "full"
    long = long_train(smi, dev)
    # 11. remat modes against each other, 2 layers at L 32,768
    remat = remat_equivalence(dev)
    # 12. ResNet-50 per-stage recompute against the plain step
    resnet_rc = resnet_recompute_check(dev)
    # 13. the composed routes (C1-C3) against the CPU
    composed = check_composed(dev)
    # 14. train BERT-Base (bench_bert_base): O2 bf16, B 256, L 128
    bert = bert_train(smi)
    # 15. its fp32 step on the card against the CPU, B 2
    bert_cpu = bert_cross_check()
    # 16. ERNIE-3.0 Base pretraining step, knowledge-masked spans, V 40,000
    ernie = ernie_train(smi)
    # 17. amp O1 in the eager loop (bf16, fp16 with GradScaler)
    amp_res = amp_check(smi)
    # 18. the health sentinel's cost and readings on the O2 GPT step
    health_res, tripped, batch = health_train(cfg, smi)
    # 19. a NaN parameter trips it; the replay names the layer-norm kernel
    trip = health_trip(tripped, batch, smi)
    del tripped, batch
    free_card()
    # 20. Model.fit in fp32: checkpoints, rollback, resume past corruption
    fit_res = fit_resume(cfg, smi)
    # 21. Transformer-base on padded batches with bool masks, O2 bf16, and
    # its fp32 step against the CPU
    tb = transformer_train(smi)
    tb_cpu = transformer_cross_check()
    # 22. ResNet-50 in fp32 through hapi Model.fit, the default TF32 flags
    rfit = resnet_fit(smi)
    # 23. the serving control plane: swap, rollback, canary, restart, the
    # admission gates and the governor, under the captured graphs
    control = serve_control(cfg, smi)
    # 24. the observability plane: Model.fit behind the server, /profile's
    # capture held to the launch counters, the engine's HTTP face
    obs = observe(cfg, smi)
    # 25. the parameter server: Wide&Deep and DeepFM at bench.py's widths,
    # eager, sync, async and pipelined with the hot-row cache
    ps_res = ps_train(smi)
    # 26. collective data parallelism: world 1 over NCCL, GPT-3 1.3B
    # through DataParallel, two gloo ranks on the card
    dp_res = dp_phase(cfg, smi)
    rows += dp_res["gpt3_rows"]
    # 27. ResNet-50 data parallelism: synchronized batch norm, world 1 over
    # NCCL captured against the plain step, two gloo ranks on the card
    rn_dp = rn_dp_phase(smi)
    # 28. ZeRO sharding at its three levels (world 1 over NCCL, captured
    # and eager, bit for bit with the plain steps), the sharded checkpoint,
    # two gloo ranks on the card
    zero = zero_phase(cfg, smi)

    # 29. report: launches from each path's own run (counters reset just
    # before it); times at the main path's shape
    result = dict(card=smi, capability=cap, launch_floor_ms=floor,
                  checks=rows, edges=edges,
                  serve=served, cpu_cross_check=cpu_res, train=trained,
                  capture_edges=cap_edges,
                  train_cpu_cross_check=train_cpu, resnet=resnet,
                  resnet_cpu_cross_check=resnet_cpu, long=long,
                  remat_equivalence=remat, resnet_recompute=resnet_rc,
                  composed=composed, bert=bert, bert_cpu_cross_check=bert_cpu,
                  ernie=ernie, amp=amp_res, health=health_res,
                  health_trip=trip, fit_resume=fit_res, transformer=tb,
                  transformer_cpu_cross_check=tb_cpu, resnet_fit=rfit,
                  serve_control=control, observe=obs, ps=ps_res, dp=dp_res,
                  resnet_dp=rn_dp, zero=zero)
    paths = {"serve": served, "serve_control": control, "train": trained,
             "resnet": resnet, "long": long, "bert": bert,
             "health": health_res, "fit": fit_res, "transformer": tb,
             "resnet_fit": rfit, "observe": obs,
             "dp": dp_res["gpt2_world1"], "dp_gpt3": dp_res["gpt3"],
             "dp_ranks": dp_res["two_ranks"],
             "resnet_dp": rn_dp["world1"],
             "resnet_dp_ranks": rn_dp["two_ranks"],
             "zero": zero["world1"], "zero_ranks": zero["two_ranks"]}
    kern = []
    for kname, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == kname]
        main_row = next(r for r in mine if (r["dtype"], r["shape"][
            :len(meta["main"][1])]) == meta["main"])
        by_path = {p: res["launches"][kname]["kernel"]
                   for p, res in paths.items()}
        kern.append(dict(
            name=kname, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=sum(by_path.values()),
            launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"],
            shape=f"{main_row['shape']} {main_row['dtype']}",
            design=main_row["design"],
            **({"bound_cuda_core_ms": main_row["bound_cuda_core_ms"]}
               if "bound_cuda_core_ms" in main_row else {}),
            **({"bound_with_floor_ms": main_row["bound_with_floor_ms"]}
               if "bound_with_floor_ms" in main_row else {}),
            **({"plain_at": main_row["plain_shape"],
                "one_pass_ms": main_row["one_pass_ms"]}
               if "plain_shape" in main_row else {}),
            **split_masked(kname, rows, paths),
            **fp32_row(kname, rows, paths)))
    result["kernels"] = kern
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"kernels": kern}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
