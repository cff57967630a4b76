#!/usr/bin/env python3
"""Where the time goes in one training step of the PyTorch/H100 port.

    python3 tools/profile_torch_train.py          # from the repository root
    python3 tools/profile_torch_train.py --long   # B 1 x 32,768, remat "full"
    python3 tools/profile_torch_train.py --bert   # BERT-Base, B 256 x 128
    python3 tools/profile_torch_train.py --fit    # hapi Model, fp32
    python3 tools/profile_torch_train.py --fit --tree DIR --tag NAME

Builds GPT-2 small at full width (random weights from seed 0, dropout 0)
and trains it with ``paddle_tpu_torch.jit.TrainStep(model, F.cross_entropy,
AdamW(lr=1e-4, weight_decay=0.01), amp_dtype=torch.bfloat16)`` at batch 8,
sequence 1024 on one card (the JAX package's ``bench_gpt2`` configuration),
or with ``--long`` on one 32,768-token sequence (max_position_embeddings
32,768) with ``GPTConfig.remat = "full"``, whose attention backward is the
split dq / dk-dv pair, or with ``--bert`` the BERT-Base classifier of
``chip_smoke.py``'s bert phase (the JAX package's ``bench_bert_base``: B
256, L 128, AdamW(1e-4), O2 bf16), or with ``--fit`` GPT-2 small at b8
s1024 in fp32 as ``hapi.Model`` trains it (``Model(net).prepare(AdamW(1e-4,
weight_decay=0.01), F.cross_entropy)``, one ``train_batch`` a step, the
step ``Model.fit`` takes: its attention backward is the fp32 one-pass
kernel, its matrix products fp32 cuBLAS with TF32 off). After the warm-up
steps (two; one with ``--long``)
it measures, with ``torch.profiler`` (CPU and CUDA activities), a window
of steps (three; one with ``--long``, a step of seconds):

* host wall time per step, device busy time (the sum of device-side event
  times on the one stream) and the idle share 1 - busy / wall;
* device time per group: each hand-written kernel (``layer_norm``: the
  layer norm's forward and backward kernels and the backward's column
  sums), the matrix products (cuBLAS), the multi-tensor optimizer update,
  other elementwise and reduction kernels, copies and fills;
* the layer norm's backward, whatever computes it (``layer_norm_backward``:
  the device time of every kernel launched under the autograd node
  ``LayerNormFunctionBackward``, the kernel or a parent's torch
  composition, and its share of the busy time);
* the matrix products by kernel name, and the top kernels overall;
* each hand-written kernel's launches per step (its wrapper's counter);

and the same window without the profiler, for its overhead. It does so
twice, the step as a user calls it (``"captured"``: on a card one CUDA
graph replay a step, so the layer norm's backward node shows no host
events and reads None) and then the same step uncaptured
(``"uncaptured"``, ``TrainStep._step_uncaptured``: every op dispatched
from Python); a checkout without the captured step profiles its one step
as ``"uncaptured"``. Writes
``chiprun_out/profile_torch_train.json`` (``profile_torch_train_long.json``
with ``--long``, ``_bert`` with ``--bert``, ``_fit`` with ``--fit``, then
``_NAME`` with ``--tag``) under the directory it is started from. With
``--tree`` it profiles the checkout at DIR (its ``paddle_tpu_torch``, and
its ``chip_smoke`` for ``--bert``), so a parent and a change can be
profiled in one call with this tool. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: where the output goes: chiprun_out/ under the directory started from
OUT = os.path.abspath("chiprun_out")

#: (batch, sequence, remat, warm-up steps, profiled steps) of each run
RUNS = {"b8s1024": (8, 1024, "", 2, 3), "long": (1, 32768, "full", 1, 1),
        "bert": (256, 128, "", 2, 3), "fit": (8, 1024, "", 2, 3)}

#: device-kernel name fragments -> group (first match wins)
GROUPS = (
    ("flash_attention_bwd_dq", ("flash_bwd_dq_",)),
    ("flash_attention_bwd_dkv", ("flash_bwd_dkv_",)),
    ("flash_attention_bwd", ("flash_bwd_kernel", "flash_bwd_tc_kernel",
                             "flash_bwd_tf32_kernel")),
    ("flash_attention", ("flash_fwd_",)),
    ("layer_norm", ("layer_norm_fwd", "layer_norm_bwd")),
    # ce_fwd_kernel / ce_bwd_kernel before the CE redesign; since, one
    # kernel a design (ce_*_rows_kernel, ce_*_stream_kernel)
    ("softmax_ce_fwd", ("ce_fwd_",)),
    ("softmax_ce_bwd", ("ce_bwd_",)),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy/fill", ("memcpy", "memset", "copy", "fill")),
)


def _group(name: str, groups=GROUPS) -> str:
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


def _device_summary(prof, wall_s, n_steps, groups=GROUPS):
    """Sums over the device-side events only (the CPU ops that launched
    them carry the same time and are skipped, so nothing counts twice).
    One stream, so the sum is the busy time. ``groups``: (group, name
    fragments) pairs, the first match wins."""
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    busy_us = sum(t for t, _ in by_name.values())
    by_group = {}
    for k, (t, c) in by_name.items():
        g = by_group.setdefault(_group(k, groups), [0.0, 0])
        g[0] += t
        g[1] += c
    per = max(1, n_steps)
    rows = sorted(((t, k, c) for k, (t, c) in by_name.items()), reverse=True)
    gemms = [r for r in rows if _group(r[1], groups) == "gemm"]
    return dict(
        wall_ms=wall_s * 1e3 / per,
        device_busy_ms=busy_us / 1e3 / per if by_name else None,
        idle_share=1.0 - busy_us / 1e6 / wall_s if by_name else None,
        device_ops_per_step=sum(c for _, c in by_name.values()) / per,
        groups={g: dict(device_ms=t / 1e3 / per, calls=c / per,
                        share=t / busy_us)
                for g, (t, c) in sorted(by_group.items(),
                                        key=lambda kv: -kv[1][0])},
        gemm_kernels=[dict(name=k[:100], device_ms=t / 1e3 / per,
                           calls=c / per) for t, k, c in gemms[:10]],
        top=[dict(name=k[:100], device_ms=t / 1e3 / per, calls=c / per)
             for t, k, c in rows[:15]])


#: the autograd node of the layer norm's backward (the port's Function)
LN_BACKWARD_NODE = "LayerNormFunctionBackward"


def _node_device_ms(prof, node, n_steps, busy_ms):
    """Device ms a step of every kernel launched under the outermost CPU
    events whose name holds `node` (an autograd node and what it calls),
    with the node's calls a step and its share of the busy time."""
    total_us, calls = 0.0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or node not in \
                e.name:
            continue
        parent = e.cpu_parent
        while parent is not None and node not in parent.name:
            parent = parent.cpu_parent
        if parent is None:
            total_us += e.device_time_total
            calls += 1
    per = max(1, n_steps)
    ms = total_us / 1e3 / per
    return dict(device_ms=ms, calls=calls / per,
                share=ms / busy_ms if busy_ms else None)


def step_modes(step, train_step, fit: bool) -> dict:
    """{"captured": the step as a user calls it, "uncaptured": the same
    TrainStep's ``_step_uncaptured`` (as ``hapi.Model.train_batch``
    takes it with ``fit``)}, or only {"uncaptured": step} for a checkout
    without the captured step."""
    if not hasattr(train_step, "_step_uncaptured"):
        return {"uncaptured": step}
    if fit:
        return {"captured": step, "uncaptured": lambda *b: float(
            train_step._step_uncaptured(*b))}
    return {"captured": step, "uncaptured": train_step._step_uncaptured}


def graph_counters(train_step):
    """A TrainStep's captures and graph pool bytes (None before capture)."""
    st = getattr(train_step, "stats", None)
    return None if st is None else {"captures": st["graph_captures"],
                                    "pool_bytes": st["graph_pool_bytes"]}


def profile_modes(steps: dict, batch, warmup: int, window: int,
                  groups=GROUPS) -> dict:
    """{mode: summary} for each of ``steps`` ({mode: fn}) in turn: warm-up
    calls, a profiled window of ``window`` calls (``_device_summary``,
    each kernel's launches a step, plain runs, designs; the profile
    itself under ``"_prof"``) and the same window unprofiled."""
    from paddle_tpu_torch.ops import kernels
    act = torch.profiler.ProfilerActivity
    out = {}
    for mode, fn in steps.items():
        for _ in range(warmup):
            fn(*batch)
        torch.cuda.synchronize()
        kernels.reset_stats()
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(window):
                loss = fn(*batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        o = out[mode] = _device_summary(prof, wall, window, groups)
        o["_prof"] = prof
        stats = kernels.all_stats()
        o["launches_per_step"] = {k: v["kernel"] / window
                                  for k, v in stats.items()}
        o["plain_runs"] = {k: v["plain"] for k, v in stats.items()}
        o["designs"] = kernels.design_stats()
        t0 = time.perf_counter()
        for _ in range(window):
            loss = fn(*batch)
        torch.cuda.synchronize()
        o["wall_ms_unprofiled"] = (time.perf_counter() - t0) * 1e3 / window
        o["loss"] = float(loss)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--long", action="store_true",
                    help="B 1 x 32,768 tokens with remat 'full'")
    ap.add_argument("--bert", action="store_true",
                    help="the BERT-Base classifier at B 256 x 128")
    ap.add_argument("--fit", action="store_true",
                    help="GPT-2 small b8 s1024 in fp32 through hapi.Model")
    ap.add_argument("--tree", default=ROOT, help="the checkout to profile")
    ap.add_argument("--tag", help="suffix of the output file's name")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA card", file=sys.stderr)
        return 2
    os.chdir(os.path.abspath(args.tree))
    sys.path.insert(0, os.getcwd())
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import functional as F
    run = ("long" if args.long else "bert" if args.bert
           else "fit" if args.fit else "b8s1024")
    B, L, remat, warmup, window = RUNS[run]
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.bert:
        import chip_smoke
        cfg = chip_smoke.bert_config()
        model = chip_smoke.bert_classifier(cfg, "cuda", seed=0)
        ids, labels = (t.cuda() for t in chip_smoke.bert_batch(cfg, B, L))
    else:
        cfg = GPTConfig.gpt2_small()
        cfg.dropout = cfg.attn_dropout = 0.0
        cfg.max_position_embeddings = max(L, cfg.max_position_embeddings)
        cfg.remat = remat
        model = GPT(cfg, device="cuda",
                    generator=torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (B, L))).cuda()
        labels = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (B, L))).cuda()
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01)
    if args.fit:
        from paddle_tpu_torch.hapi import Model
        m = Model(model)
        m.prepare(opt, F.cross_entropy)

        def step(ids, labels):
            return m.train_batch([ids], [labels])[0]
    else:
        step = TrainStep(model, F.cross_entropy, opt,
                         amp_dtype=torch.bfloat16)
    if args.fit:
        m.train_batch([ids], [labels])  # builds the step
    out = profile_modes(step_modes(step, m._train_step if args.fit else step,
                                   args.fit), (ids, labels), warmup, window)
    for mode, o in out.items():
        o["layer_norm_backward"] = (None if mode == "captured" else
                                    _node_device_ms(o.pop("_prof"),
                                                    LN_BACKWARD_NODE, window,
                                                    o["device_busy_ms"]))
    out["graphs"] = graph_counters(m._train_step if args.fit else step)
    out.update(card=smi, tree=os.getcwd(), batch=B, seq=L, remat=remat,
               window=window, dtype="float32" if args.fit else "O2 bfloat16",
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    os.makedirs(OUT, exist_ok=True)
    name = {"long": "_long", "bert": "_bert", "fit": "_fit"}.get(run, "")
    name += f"_{args.tag}" if args.tag else ""
    with open(os.path.join(OUT, f"profile_torch_train{name}.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
