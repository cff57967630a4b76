#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (paddle_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py            # from the repository root

Phases, each of which raises (exit code != 0, with its traceback) on a
failure:

1. device   - the card's name, capability, and `nvidia-smi` name/power limit;
2. build    - build the hand-written kernels from csrc/ (timed);
3. kernels  - each kernel against its plain PyTorch version on the card, at
              the serving path's shapes, fp32 and bf16, with kernel, plain,
              library and bound times; then, for correctness only, at the
              edges each kernel claims (ragged tails, Lk > Lq, D 8-128,
              ctx 0 and page boundaries, N up to 4096);
4. serve    - GPT-2 small at full width (12 layers, hidden 768, 12 heads,
              vocab 50304, fp32, random weights from a seed) through
              ServingEngine(max_batch=32, max_len=1024, page_size=16): 64
              greedy requests of 32-512 prompt tokens plus two longer than
              512, 32 new tokens each; every kernel must have launched and no
              plain version may have run; TTFT, TPOT and tokens/s;
5. cpu      - the same weights on the CPU (plain versions) against the card:
              prefill logits and 8 teacher-forced decode steps for 2 requests;
6. report   - the `kernels` JSON line, the card's name and power limit, and
              the device JSON line last.

Numerics: float32 matrix products run in full fp32
(torch.backends.cuda.matmul.allow_tf32 = False), so the card and the CPU
compute the same function. Needs one card and imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (dense): HBM 3.35 TB/s; fp32 on CUDA cores
# 67 TFLOP/s; bf16 on tensor cores 989 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
OUT_DIR = "chiprun_out"


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes, flops, dtype):
    """Least time for the work: bytes over HBM rate vs ops over peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, iters=20, reps=5, warmup=3):
    """Mean device time of one fn() call. `iters` calls are captured in
    one CUDA graph and the graph is replayed `reps` times between two
    events, so the host's launch cost (which dominates a call of a few
    microseconds) does not enter the time."""
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


def max_err(got, ref):
    return float((got.float() - ref.float()).abs().max())


# ----------------------------- phase 3: kernels -----------------------------


def check_layer_norm(dev, gen, rows_list, N):
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for R in rows_list:
            x = torch.randn(R, N, device=dev, generator=gen).to(dtype)
            g = (1 + 0.1 * torch.randn(N, device=dev, generator=gen)).to(dtype)
            b = (0.1 * torch.randn(N, device=dev, generator=gen)).to(dtype)
            y = ln.layer_norm_fwd(x, g, b)
            torch.cuda.synchronize()
            err = max_err(y, ln.layer_norm_plain(x.float(), g.float(),
                                                 b.float()))
            isz = x.element_size()
            bnd, by = bound_ms(2 * R * N * isz + 2 * N * isz, 8 * R * N,
                               dtype)
            rows.append(dict(
                kernel="layer_norm", dtype=str(dtype)[6:], shape=f"R={R} N={N}",
                max_abs_err=err, tol=TOL[dtype],
                ms=cuda_ms(lambda: ln.layer_norm_fwd(x, g, b)),
                plain_ms=cuda_ms(lambda: ln.layer_norm_plain(x, g, b)),
                library_ms=cuda_ms(lambda: torch.nn.functional.layer_norm(
                    x, (N,), g, b, 1e-5)),
                bound_ms=bnd, bound_by=by))
    return rows


def check_flash(dev, gen, lengths, H, D):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for L in lengths:
            qkv = torch.randn(1, L, 3, H, D, device=dev,
                              generator=gen).to(dtype)
            q, k, v = qkv.unbind(2)  # strided views, as the model passes them
            out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_attention_plain(
                q.float(), k.float(), v.float(), causal=True)
            err = max(max_err(out, ref_out), max_err(lse, ref_lse))
            isz = q.element_size()
            pairs = L * (L + 1) // 2  # causal (q, k) pairs
            bnd, by = bound_ms(4 * L * H * D * isz + 4 * H * L,
                               4 * H * D * pairs, dtype)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            rows.append(dict(
                kernel="flash_attention", dtype=str(dtype)[6:],
                shape=f"B=1 L={L} H={H} D={D} causal",
                max_abs_err=err, tol=TOL[dtype],
                ms=cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, True)),
                plain_ms=cuda_ms(lambda: fa.flash_attention_plain(
                    q, k, v, True)),
                library_ms=cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True)),
                bound_ms=bnd, bound_by=by))
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
        torch.cuda.synchronize()
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
            max_abs_err=err, tol=TOL[dtype],
            ms=cuda_ms(lambda: pa.paged_attention(q, kp, vp, bt, cl)),
            plain_ms=cuda_ms(lambda: pa.paged_attention_plain(
                q, kp, vp, bt, cl)),
            library_ms=None, bound_ms=bnd, bound_by=by))
    return rows


def check_edges(dev, gen):
    """Correctness only, at the limits each kernel claims beyond the main
    path's shapes: any R and N up to 4096 (layer norm); any L >= 1, ragged
    tails, Lk > Lq with the causal offset, D from 8 to 128 (flash, where
    D = 128 needs more than 48 KB of shared memory); ctx 0, one token and
    page boundaries (paged). Returns {kernel: worst error / tolerance}."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    def randn(*shape, dtype):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    worst = {"layer_norm": 0.0, "flash_attention": 0.0,
             "paged_attention": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[dtype]
        for R, N in ((1, 768), (3, 100), (5, 4096)):
            x = randn(R, N, dtype=dtype)
            g = 1 + 0.1 * randn(N, dtype=torch.float32)
            b = 0.1 * randn(N, dtype=torch.float32)
            err = max_err(ln.layer_norm_fwd(x, g, b),
                          ln.layer_norm_plain(x.float(), g, b))
            worst["layer_norm"] = max(worst["layer_norm"], err / tol)
        for Lq, Lk, causal, D in ((1, 1, True, 64), (16, 16, True, 64),
                                  (100, 100, True, 64), (37, 130, True, 64),
                                  (100, 70, False, 64), (50, 50, True, 128),
                                  (20, 20, False, 8)):
            q = randn(2, Lq, 3, D, dtype=dtype)
            k = randn(2, Lk, 3, D, dtype=dtype)
            v = randn(2, Lk, 3, D, dtype=dtype)
            out, lse = fa.flash_attention_fwd(q, k, v, causal)
            ref_out, ref_lse = fa.flash_attention_plain(
                q.float(), k.float(), v.float(), causal)
            err = max(max_err(out, ref_out), max_err(lse, ref_lse))
            worst["flash_attention"] = max(worst["flash_attention"],
                                           err / tol)
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
    torch.cuda.synchronize()
    return worst


# ------------------------------ phase 4: serve ------------------------------


def percentile(xs, p):
    return float(np.percentile(np.asarray(xs, np.float64), p))


def serve(model, cfg, card):
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.ops import kernels
    eng = ServingEngine(model, max_batch=32, max_len=1024, page_size=16,
                        name="gpt2_small")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size,
                            int(rng.integers(32, 513))).tolist()
               for _ in range(64)]
    prompts += [rng.integers(1, cfg.vocab_size, n).tolist()
                for n in (700, 960)]  # the 1024 prefill bucket
    max_new = 32
    # warm-up request (cuBLAS handles, first allocations); not counted
    eng.generate(prompts[0][:40], max_new_tokens=4)
    kernels.reset_stats()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = kernels.all_stats()
    for r in reqs:
        toks = r.result(timeout=0)
        if len(toks) != max_new or r.finish_reason != "length":
            raise AssertionError(f"request {r.rid}: {len(toks)} tokens, "
                                 f"{r.finish_reason}")
    for name, st in stats.items():
        if st["kernel"] <= 0 or st["plain"] != 0:
            raise AssertionError(f"{name}: counters {st} — the kernel must "
                                 f"launch and the plain version must not run")
    if eng.allocator.outstanding():
        raise AssertionError(f"leaked pages {eng.allocator.outstanding()}")
    ttft = [r.ttft_s for r in reqs]
    tpot = [r.tpot_s for r in reqs]
    n_tok = sum(len(r.generated) for r in reqs)
    res = dict(requests=len(reqs), prompt_tokens=sum(map(len, prompts)),
               generated_tokens=n_tok, wall_s=wall,
               tokens_per_s=n_tok / wall,
               ttft_p50_ms=percentile(ttft, 50) * 1e3,
               ttft_p99_ms=percentile(ttft, 99) * 1e3,
               tpot_p50_ms=percentile(tpot, 50) * 1e3,
               tpot_p99_ms=percentile(tpot, 99) * 1e3,
               stats=dict(eng.stats), launches=stats,
               decode_iterations=eng.stats["iterations"],
               prefills=eng.stats["prefills"], card=card)
    log(f"serve: {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s "
        f"({res['tokens_per_s']:.1f} tok/s) TTFT p50 "
        f"{res['ttft_p50_ms']:.2f} ms p99 {res['ttft_p99_ms']:.2f} ms, TPOT "
        f"p50 {res['tpot_p50_ms']:.3f} ms p99 {res['tpot_p99_ms']:.3f} ms "
        f"[{card}]")
    log(f"serve: launches {json.dumps(stats)}; iterations "
        f"{eng.stats['iterations']}, prefills {eng.stats['prefills']}")
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


# --------------------------------- main -------------------------------------


KERNELS = {
    "layer_norm": dict(source="paddle_tpu_torch/csrc/layer_norm.cu",
                       replaces="paddle_tpu/ops/pallas/layer_norm.py:44",
                       main="R=1024 N=768"),
    "flash_attention": dict(
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:804",
        main="B=1 L=1024 H=12 D=64 causal"),
    "paged_attention": dict(
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/ops/pallas/paged_attention.py:162", main="W=32"),
}


def main():
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

    # 3. kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = (check_layer_norm(dev, gen, (32, 1024), 768)
            + check_flash(dev, gen, (64, 512, 1024), 12, 64)
            + check_paged(dev, gen, 32, 12, 64, 16, 1024))
    for r in rows:
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        log(f"kernel {r['kernel']:<15} {r['dtype']:<8} {r['shape']:<38} "
            f"err {r['max_abs_err']:.2e} (tol {r['tol']:g})  "
            f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
            f"library_ms {lib} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']}) [{smi}]")
    bad = [r for r in rows if not r["max_abs_err"] <= r["tol"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    edges = check_edges(dev, gen)
    log("edges: worst error / tolerance " + ", ".join(
        f"{k} {v:.3f}" for k, v in edges.items()))
    if not all(v <= 1.0 for v in edges.values()):
        raise AssertionError(f"kernels disagree at their edges: {edges}")

    # 4. serve GPT-2 small at full width
    cfg = GPTConfig.gpt2_small()
    cfg.dropout = cfg.attn_dropout = 0.0
    model = GPT(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    model.eval()
    served, prompts = serve(model, cfg, smi)

    # 5. cross-check on the CPU
    cpu_res = cross_check(model, cfg, prompts)

    # 6. report
    kern = []
    for kname, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == kname]
        main_row = next(r for r in mine if r["dtype"] == "float32"
                        and r["shape"].startswith(meta["main"]))
        kern.append(dict(
            name=kname, route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=served["launches"][kname]["kernel"],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], shape=main_row["shape"]))
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, capability=cap, checks=rows, edges=edges,
                       serve=served, cpu_cross_check=cpu_res, kernels=kern),
                  f, indent=1)
    print(json.dumps({"kernels": kern}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
