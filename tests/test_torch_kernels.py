"""The port's kernel modules (paddle_tpu_torch/ops/kernels) against the JAX
package's Pallas kernels.

The CUDA kernels run only on a card (see chip_smoke.py); here each
module's plain PyTorch version — which a CPU tensor takes — is held
against the JAX kernel run as the JAX package's own tests run it on the
CPU: the Pallas interpreter (``interpret=True``), and the XLA reference.
The same numpy inputs, made from a seed, go to both.

Tolerances: fp32 atol 2e-5 (the two sum in another order); bf16 inputs
are compared in fp32 at atol 2e-2 (one bf16 rounding of an output below
4 is at most 2**-7; the TPU kernel also rounds p to bf16 before p @ v).
Backward outputs in fp32 at atol 1e-5 (gradients of order 1, sums in
another order). The CUDA argument checks are called directly, on CPU
tensors. The kernel-backed forwards are autograd Functions on both
devices; the guard tests below pin that their outputs carry the
Function's backward node.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import layer_norm as jln
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.ops.pallas import softmax_ce as jsce
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import layer_norm as ln
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.ops.kernels import softmax_ce as sce

BWD_ATOL = 1e-5

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    """The same numpy array as a jax and a torch array of `dtype`."""
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a).astype(jnp.dtype(dtype)),
            torch.from_numpy(a).to(TDT[dtype]))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ------------------------------- layer norm ---------------------------------


class TestLayerNorm:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("R,N", [(256, 128), (300, 256)])
    def test_plain_matches_pallas_interpret(self, dtype, R, N):
        rng = np.random.default_rng(R + N)
        jx, tx = _pair(rng.normal(size=(R, N)), dtype)
        # gamma near 0.5 keeps |y| < 4, inside the bf16 tolerance
        jg, tg = _pair(0.5 + 0.05 * rng.normal(size=N), dtype)
        jb, tb = _pair(0.1 * rng.normal(size=N), dtype)
        want = jln._ln_fwd_pallas(jx, jg, jb, eps=1e-5, interpret=True)
        got = ln.layer_norm_fwd(tx, tg, tb, 1e-5)
        assert got.dtype == TDT[dtype]
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                                   rtol=0)

    def test_plain_matches_xla_on_decode_rows(self):
        """R = 5 (a decode batch) takes the XLA composition on the TPU;
        the port's kernel takes every R, so its plain version must too."""
        rng = np.random.default_rng(1)
        jx, tx = _pair(rng.normal(size=(5, 3, 64)), "float32")
        jg, tg = _pair(rng.normal(size=64), "float32")
        jb, tb = _pair(rng.normal(size=64), "float32")
        want = jln.fused_layer_norm(jx, jg, jb, 1e-5)
        got = ln.fused_layer_norm(tx, tg, tb, 1e-5)
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)

    def test_weights_in_another_type_than_x(self):
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.normal(size=(7, 32)).astype(np.float32))
        g = torch.ones(32, dtype=torch.bfloat16)
        b = torch.zeros(32, dtype=torch.bfloat16)
        y = ln.layer_norm_fwd(x, g, b)
        assert y.dtype == torch.float32
        ref = torch.nn.functional.layer_norm(x, (32,), eps=1e-5)
        torch.testing.assert_close(y, ref, atol=2e-5, rtol=0)

    def test_cpu_counts_plain(self):
        before = dict(ln._stats)
        x = torch.ones(4, 8)
        ln.layer_norm_fwd(x, torch.ones(8), torch.zeros(8))
        assert ln._stats["plain"] == before["plain"] + 1
        assert ln._stats["kernel"] == before["kernel"]

    @pytest.mark.parametrize("case", ["strided", "fp16", "mixed_wb",
                                      "gamma_shape", "rank"])
    def test_kernel_argument_checks_raise(self, case):
        x, g, b = torch.ones(4, 8), torch.ones(8), torch.zeros(8)
        if case == "strided":
            x = torch.ones(8, 4).t()
        elif case == "fp16":
            x = x.half()
        elif case == "mixed_wb":
            b = b.bfloat16()
        elif case == "gamma_shape":
            g = torch.ones(7)
        else:
            x = torch.ones(2, 2, 8)
        with pytest.raises(ValueError):
            ln.check_args(x, g, b)
        ln.check_args(torch.ones(4, 8), torch.ones(8), torch.zeros(8))


class TestLayerNormBackward:
    @pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
    def test_function_backward_matches_jax_grad(self, gdtype):
        """dx, dgamma and dbeta of the port's Function against jax.grad of
        the reference's custom-vjp ``fused_layer_norm``; dgamma and dbeta
        come back in gamma's type in both."""
        rng = np.random.default_rng(7)
        x = rng.normal(size=(2, 5, 48)).astype(np.float32)
        g = (1 + 0.1 * rng.normal(size=48)).astype(np.float32)
        b = (0.1 * rng.normal(size=48)).astype(np.float32)
        dy = rng.normal(size=(2, 5, 48)).astype(np.float32)
        jg, tg = _pair(g, gdtype)
        jb, tb = _pair(b, gdtype)

        def f(x_, g_, b_):
            return jnp.sum(jln.fused_layer_norm(x_, g_, b_, 1e-5) * dy)

        want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jg, jb)
        tx = torch.from_numpy(x).requires_grad_(True)
        tg.requires_grad_(True)
        tb.requires_grad_(True)
        (ln.fused_layer_norm(tx, tg, tb, 1e-5) * torch.from_numpy(dy)).sum(
            ).backward()
        got = (tx.grad, tg.grad, tb.grad)
        assert tg.grad.dtype == TDT[gdtype] and tb.grad.dtype == TDT[gdtype]
        atol = BWD_ATOL if gdtype == "float32" else 2e-2
        for gt, w in zip(got, want):
            np.testing.assert_allclose(_np(gt), _np(w), atol=atol, rtol=0)

    def test_output_carries_the_function(self):
        """Guard: the layer norm's output is the Function's own output, on
        the CPU as on a card, so the kernel's forward never leaves the
        autograd graph."""
        x = torch.randn(3, 4, 16, requires_grad=True)
        for y in (ln.fused_layer_norm(x, torch.ones(16), torch.zeros(16)),
                  F.layer_norm(x, 16, torch.ones(16), torch.zeros(16))):
            assert y.grad_fn._forward_cls is ln.LayerNormFunction
        y.sum().backward()
        assert x.grad is not None and x.grad.shape == x.shape


# ---------------------------- flash attention -------------------------------


def _qkv(rng, B, Lq, Lk, H, D, dtype):
    q = _pair(rng.normal(size=(B, Lq, H, D)), dtype)
    k = _pair(rng.normal(size=(B, Lk, H, D)), dtype)
    v = _pair(rng.normal(size=(B, Lk, H, D)), dtype)
    return q, k, v


class TestFlashAttention:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal,Lq,Lk", [(True, 100, 100),
                                              (False, 100, 100),
                                              (True, 64, 130)])
    def test_plain_matches_tiled_pallas(self, dtype, causal, Lq, Lk):
        rng = np.random.default_rng(Lq + Lk + causal)
        (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, Lq, Lk, 2, 32, dtype)
        scale = 1.0 / np.sqrt(32)
        jout, jlse = jfa._fa_fwd_pallas(jq, jk, jv, None, causal, scale,
                                        interpret=True, blocks=(64, 64))
        out, lse = fa.flash_attention_fwd(tq, tk, tv, causal, scale)
        assert out.dtype == TDT[dtype] and lse.dtype == torch.float32
        assert lse.shape == (2, 2, Lq)
        np.testing.assert_allclose(_np(out), _np(jout), atol=TOL[dtype],
                                   rtol=0)
        np.testing.assert_allclose(_np(lse), _np(jlse), atol=TOL[dtype],
                                   rtol=0)

    @pytest.mark.parametrize("causal", [True, False])
    def test_plain_matches_small_path_pallas(self, causal):
        rng = np.random.default_rng(11)
        (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 128, 128, 3, 16,
                                            "float32")
        jout, jlse = jfa._fa_small_fwd_pallas(jq, jk, jv, None, causal,
                                              0.25, interpret=True)
        out, lse = fa.flash_attention_fwd(tq, tk, tv, causal, 0.25)
        np.testing.assert_allclose(_np(out), _np(jout), atol=2e-5, rtol=0)
        np.testing.assert_allclose(_np(lse), _np(jlse), atol=2e-5, rtol=0)

    @pytest.mark.parametrize("L", [1, 16, 37])
    def test_short_buckets_match_xla(self, L):
        """The serving prefill buckets start at 16; the kernel takes any
        L >= 1, where the TPU used XLA below 64."""
        rng = np.random.default_rng(L)
        (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, L, L, 4, 16, "float32")
        want = jfa.flash_attention_xla(jq, jk, jv, causal=True)
        got, _ = fa.flash_attention_fwd(tq, tk, tv, causal=True)
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)

    @pytest.mark.parametrize("kind", ["bool", "additive"])
    def test_masked_composition_matches_xla(self, kind):
        rng = np.random.default_rng(3)
        (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 12, 12, 2, 8, "float32")
        keep = rng.random((2, 1, 12, 12)) > 0.3
        keep[0, 0, 5] = False  # a fully masked row gives 0
        if kind == "bool":
            jm, tm = jnp.asarray(keep), torch.from_numpy(keep)
        else:
            add = np.where(keep, 0.0, -1e9).astype(np.float32)
            jm, tm = jnp.asarray(add), torch.from_numpy(add)
        want = jfa.flash_attention_xla(jq, jk, jv, mask=jm, causal=True)
        got = fa.flash_attention(tq, tk, tv, mask=tm, causal=True)
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)

    def test_cpu_counts_plain_and_dropout_takes_composition(self):
        t = torch.ones(1, 4, 1, 8)
        before = dict(fa._stats)
        fa.flash_attention(t, t, t, causal=True)
        assert fa._stats["plain"] == before["plain"] + 1
        gen = torch.Generator().manual_seed(0)
        out = fa.flash_attention(t, t, t, causal=True, dropout_p=0.5,
                                 generator=gen)
        assert out.shape == t.shape
        assert fa._stats["plain"] == before["plain"] + 1
        assert fa._stats["kernel"] == before["kernel"]

    @pytest.mark.parametrize("case", ["D_big", "D_not_8", "causal_lq_gt_lk",
                                      "mixed_types", "fp16", "last_stride",
                                      "shape"])
    def test_kernel_argument_checks_raise(self, case):
        q = k = v = torch.ones(1, 8, 2, 16)
        causal = True
        if case == "D_big":
            q = k = v = torch.ones(1, 8, 2, 136)
        elif case == "D_not_8":
            q = k = v = torch.ones(1, 8, 2, 12)
        elif case == "causal_lq_gt_lk":
            k = v = torch.ones(1, 4, 2, 16)
        elif case == "mixed_types":
            v = v.bfloat16()
        elif case == "fp16":
            q = k = v = q.half()
        elif case == "last_stride":
            q = torch.ones(1, 8, 16, 2).transpose(2, 3)
        else:
            k = torch.ones(1, 8, 3, 16)
        with pytest.raises(ValueError):
            fa.check_args(q, k, v, causal)
        fa.check_args(torch.ones(1, 8, 2, 16), torch.ones(1, 8, 2, 16),
                      torch.ones(1, 8, 2, 16), True)


class TestFlashAttentionBackward:
    @staticmethod
    def _inputs(seed, B, Lq, Lk, H, D):
        rng = np.random.default_rng(seed)
        (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, B, Lq, Lk, H, D, "float32")
        jdo, tdo = _pair(rng.normal(size=(B, Lq, H, D)), "float32")
        return (jq, jk, jv, jdo), (tq, tk, tv, tdo)

    @staticmethod
    def _port_bwd(tq, tk, tv, tdo, causal, scale):
        out, lse = fa.flash_attention_fwd(tq, tk, tv, causal, scale)
        return fa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal,
                                      scale)

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("L", [128, 192, 100])
    def test_plain_matches_fused_pallas(self, L, causal):
        """Against the one-pass backward in the Pallas interpreter, with
        64-row blocks: several q and k blocks, and ragged tails at 100."""
        (jq, jk, jv, jdo), (tq, tk, tv, tdo) = self._inputs(L + causal, 2, L,
                                                            L, 2, 32)
        scale = 1.0 / np.sqrt(32)
        jout, jlse = jfa._fa_fwd_pallas(jq, jk, jv, None, causal, scale,
                                        interpret=True, blocks=(64, 64))
        want = jfa._fa_bwd_fused_pallas(jq, jk, jv, jout, jlse, jdo, None,
                                         causal, scale, interpret=True,
                                         blocks=(64, 64))
        got = self._port_bwd(tq, tk, tv, tdo, causal, scale)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), atol=BWD_ATOL, rtol=0)

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("L", [100, 72])
    def test_bf16_d128_plain_matches_fused_pallas(self, L, causal):
        """bf16 at head dim 128 (the tensor-core walk's second instance)
        and L off the 64-row tile, against the one-pass Pallas kernel in
        the interpreter on the same bf16 inputs. The reference rounds P
        and dS to bf16 before its products and each output to bf16 once;
        the plain version computes in fp32 and rounds once: 2e-2 of each
        output's scale, max(1, max |ref|), as on the card."""
        rng = np.random.default_rng(L + 7 * causal)
        (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, L, L, 2, 128,
                                            "bfloat16")
        jdo, tdo = _pair(rng.normal(size=(1, L, 2, 128)), "bfloat16")
        scale = 1.0 / np.sqrt(128)
        jout, jlse = jfa._fa_fwd_pallas(jq, jk, jv, None, causal, scale,
                                        interpret=True, blocks=(64, 64))
        want = jfa._fa_bwd_fused_pallas(jq, jk, jv, jout, jlse, jdo, None,
                                         causal, scale, interpret=True,
                                         blocks=(64, 64))
        got = self._port_bwd(tq, tk, tv, tdo, causal, scale)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            w = _np(w)
            tol = 2e-2 * max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(_np(g), w, atol=tol, rtol=0)

    @pytest.mark.parametrize("causal", [True, False])
    def test_plain_matches_small_path_pallas(self, causal):
        (jq, jk, jv, jdo), (tq, tk, tv, tdo) = self._inputs(5, 2, 128, 128,
                                                            3, 16)
        jout, jlse = jfa._fa_small_fwd_pallas(jq, jk, jv, None, causal, 0.25,
                                              interpret=True)
        want = jfa._fa_small_bwd_pallas(jq, jk, jv, jout, jlse, jdo, None,
                                        causal, 0.25, interpret=True)
        got = self._port_bwd(tq, tk, tv, tdo, causal, 0.25)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), atol=BWD_ATOL, rtol=0)

    @pytest.mark.parametrize("Lq,Lk", [(40, 40), (24, 56)])
    def test_function_matches_jax_grad_of_xla(self, Lq, Lk):
        """The Function's gradients against jax.grad of the reference's
        composition, causal with the kv offset when Lk > Lq."""
        (jq, jk, jv, jdo), (tq, tk, tv, tdo) = self._inputs(Lq + Lk, 2, Lq,
                                                            Lk, 2, 16)

        def f(q, k, v):
            return jnp.sum(jfa.flash_attention_xla(q, k, v, causal=True)
                           * jdo)

        want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
        leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        (fa.flash_attention(*leaves, causal=True) * tdo).sum().backward()
        for t, w in zip(leaves, want):
            np.testing.assert_allclose(_np(t.grad), _np(w), atol=BWD_ATOL,
                                       rtol=0)

    def test_output_carries_the_function_and_counts_plain(self):
        """Guard: attention's output is the Function's own output (both
        devices take the Function), and on the CPU its backward runs the
        plain version."""
        q = torch.randn(1, 8, 2, 16, requires_grad=True)
        before = dict(fa._bwd_stats)
        for out in (fa.flash_attention(q, q, q, causal=True),
                    F.scaled_dot_product_attention(q, q, q, is_causal=True)):
            assert out.grad_fn._forward_cls is fa.FlashAttentionFunction
        out.sum().backward()
        assert fa._bwd_stats["plain"] == before["plain"] + 1
        assert fa._bwd_stats["kernel"] == before["kernel"]
        assert q.grad.shape == q.shape


# ---------------------------- paged attention -------------------------------


def _pool(rng, B, H, D, page_size, num_pages, pps, dtype):
    q = _pair(rng.normal(size=(B, H, D)), dtype)
    kp = _pair(rng.normal(size=(num_pages, page_size, H, D)), dtype)
    vp = _pair(rng.normal(size=(num_pages, page_size, H, D)), dtype)
    bt = rng.integers(0, num_pages, (B, pps)).astype(np.int32)
    return q, kp, vp, (jnp.asarray(bt), torch.from_numpy(bt))


class TestPagedAttention:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_matches_pallas_interpret(self, dtype):
        """ctx 0 (idle slot: exactly 0), a partial page, a full page and
        several pages."""
        rng = np.random.default_rng(0)
        (jq, tq), (jk, tk), (jv, tv), (jbt, tbt) = _pool(
            rng, 4, 4, 32, 8, 10, 4, dtype)
        ctx = np.array([0, 5, 8, 27], np.int32)
        jout = jpa._paged_attn_pallas(jq, jk, jv, jbt, jnp.asarray(ctx),
                                      1.0 / np.sqrt(32), 4, interpret=True)
        out = pa.paged_attention(tq, tk, tv, tbt, torch.from_numpy(ctx))
        assert out.dtype == TDT[dtype]
        np.testing.assert_allclose(_np(out), _np(jout), atol=TOL[dtype],
                                   rtol=0)
        assert not _np(out)[0].any()

    def test_plain_matches_xla_reference(self):
        rng = np.random.default_rng(1)
        (jq, tq), (jk, tk), (jv, tv), (jbt, tbt) = _pool(
            rng, 3, 2, 16, 4, 9, 5, "float32")
        ctx = np.array([20, 1, 13], np.int32)
        want = jpa.paged_attention_xla(jq, jk, jv, jbt, jnp.asarray(ctx))
        got = pa.paged_attention(tq, tk, tv, tbt, torch.from_numpy(ctx))
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)

    def test_cpu_counts_plain(self):
        before = dict(pa._stats)
        pa.paged_attention(torch.ones(1, 1, 8), torch.ones(2, 4, 1, 8),
                           torch.ones(2, 4, 1, 8),
                           torch.zeros(1, 1, dtype=torch.int32),
                           torch.ones(1, dtype=torch.int32))
        assert pa._stats["plain"] == before["plain"] + 1
        assert pa._stats["kernel"] == before["kernel"]
        assert set(kernels.all_stats()) == {
            "layer_norm", "layer_norm_bwd", "flash_attention", "flash_attention_bwd",
            "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
            "flash_attention_masked", "flash_attention_bwd_masked",
            "flash_attention_bwd_dq_masked",
            "flash_attention_bwd_dkv_masked", "paged_attention", "softmax_ce_fwd", "softmax_ce_bwd",
            "fused_bn_fwd", "fused_bn_bwd_reduce", "fused_bn_bwd_dx",
            "conv1x1_stats"}

    @pytest.mark.parametrize("case", ["fp16", "bt_int64", "ctx_shape",
                                      "pool_strided", "D_big", "q_heads"])
    def test_kernel_argument_checks_raise(self, case):
        q = torch.ones(2, 3, 8)
        kp = vp = torch.ones(5, 4, 3, 8)
        bt = torch.zeros(2, 3, dtype=torch.int32)
        cl = torch.ones(2, dtype=torch.int32)
        if case == "fp16":
            q, kp, vp = q.half(), kp.half(), vp.half()
        elif case == "bt_int64":
            bt = bt.long()
        elif case == "ctx_shape":
            cl = torch.ones(3, dtype=torch.int32)
        elif case == "pool_strided":
            kp = vp = torch.ones(4, 5, 3, 8).transpose(0, 1)
        elif case == "D_big":
            q = torch.ones(2, 3, 136)
            kp = vp = torch.ones(5, 4, 3, 136)
        else:
            q = torch.ones(2, 4, 8)
        with pytest.raises(ValueError):
            pa.check_args(q, kp, vp, bt, cl)
        pa.check_args(torch.ones(2, 3, 8), torch.ones(5, 4, 3, 8),
                      torch.ones(5, 4, 3, 8),
                      torch.zeros(2, 3, dtype=torch.int32),
                      torch.ones(2, dtype=torch.int32))


class TestPagedPartitions:
    """The partition split of the paged kernel (flash-decoding): its
    arithmetic, and ``paged_attention_split_plain`` (per-partition
    softmax states, then the fixed-order merge, as the two CUDA kernels
    compute them) against the reference's dense ``paged_attention_xla``
    at the split's edges."""

    @pytest.mark.parametrize("pps,page,want", [
        (64, 16, (16, 4)),   # serving: max_len 1024, page 16
        (40, 16, (16, 3)),   # a short last partition
        (16, 16, (16, 1)),
        (1, 16, (16, 1)),
        (120, 5, (51, 3)),   # 255-token partitions
        (3, 512, (1, 3)),    # a page above PART_TOKENS: one a partition
        (600, 1, (256, 3))])
    def test_partitions(self, pps, page, want):
        assert pa.partitions(pps, page) == want
        part_pages, n_parts = want
        # every page of the row is in exactly one partition
        assert (n_parts - 1) * part_pages < pps <= n_parts * part_pages

    @staticmethod
    def _lens(part, cap):
        return {
            "ctx_0": [0, 0],
            "ctx_1": [1, 0],
            "boundary": [part - 1, part, part + 1],
            "second_boundary": [2 * part - 1, 2 * part, 2 * part + 1],
            "past_the_table": [cap - 1, cap, cap + 37],
            "one_long_lane": [cap, 1, 2, 3, 0],
        }

    @pytest.mark.parametrize("case", ["ctx_0", "ctx_1", "boundary",
                                      "second_boundary", "past_the_table",
                                      "one_long_lane"])
    @pytest.mark.parametrize("page,pps", [(16, 40), (5, 120)])
    def test_split_plain_matches_xla(self, case, page, pps):
        part_pages, _ = pa.partitions(pps, page)
        ctx = np.array(self._lens(part_pages * page, pps * page)[case],
                       np.int32)
        B, H, D = len(ctx), 2, 16
        rng = np.random.default_rng(page + pps)
        num_pages = 1 + B * pps
        (jq, tq), (jk, tk), (jv, tv) = (
            _pair(rng.normal(size=shape), "float32")
            for shape in ((B, H, D), (num_pages, page, H, D),
                          (num_pages, page, H, D)))
        bt = (1 + rng.permutation(B * pps)).astype(np.int32).reshape(B, pps)
        want = jpa.paged_attention_xla(jq, jk, jv, jnp.asarray(bt),
                                       jnp.asarray(ctx))
        got = pa.paged_attention_split_plain(tq, tk, tv,
                                             torch.from_numpy(bt),
                                             torch.from_numpy(ctx))
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)
        # ctx 0 gives exactly 0, as the reference's idle slot
        assert not _np(got)[ctx == 0].any()
        # and the wrapper's plain version (what a CPU tensor runs) agrees
        dense = pa.paged_attention(tq, tk, tv, torch.from_numpy(bt),
                                   torch.from_numpy(ctx))
        np.testing.assert_allclose(_np(got), _np(dense), atol=2e-5, rtol=0)

    def test_split_plain_bf16(self):
        """bf16 pools: the states in fp32, one rounding at the end."""
        rng = np.random.default_rng(3)
        (jq, tq), (jk, tk), (jv, tv), (jbt, tbt) = _pool(
            rng, 3, 2, 32, 16, 40, 20, "bfloat16")
        ctx = np.array([320, 256, 17], np.int32)
        want = jpa.paged_attention_xla(jq, jk, jv, jbt, jnp.asarray(ctx))
        got = pa.paged_attention_split_plain(tq, tk, tv, tbt,
                                             torch.from_numpy(ctx))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=0)

    def test_design_names_the_split(self):
        kp = torch.zeros(9, 16, 2, 64)
        bt = torch.zeros(2, 64, dtype=torch.int32)
        assert pa.kernel_design(kp, kp, bt) == (
            "4 partitions x 256 tokens, 16-byte loads")
        odd = torch.zeros(9, 16, 2, 36, dtype=torch.bfloat16)  # 72 bytes
        assert pa.kernel_design(odd, odd, bt).endswith("element loads")


class TestCacheUpdates:
    def test_cache_append_matches_reference(self):
        rng = np.random.default_rng(4)
        kp = rng.normal(size=(6, 4, 2, 8)).astype(np.float32)
        bt = np.array([[1, 2], [3, 4], [5, 0]], np.int32)
        ctx = np.array([5, 0, 3], np.int32)
        active = np.array([True, True, False])
        k_new = rng.normal(size=(3, 2, 8)).astype(np.float32)
        jk, jv = jpa._append_impl(jnp.asarray(kp), jnp.asarray(kp),
                                  jnp.asarray(k_new), jnp.asarray(-k_new),
                                  jnp.asarray(bt), jnp.asarray(ctx),
                                  jnp.asarray(active))
        tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(kp.copy())
        pa.cache_append(tk, tv, torch.from_numpy(k_new),
                        torch.from_numpy(-k_new), torch.from_numpy(bt),
                        torch.from_numpy(ctx), torch.from_numpy(active))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    def test_prefill_append_matches_reference_outside_null_page(self):
        """Live positions in [start, length) land where the reference puts
        them; the reference parks the rest on the null page, the port
        leaves them unwritten."""
        rng = np.random.default_rng(5)
        kp = np.zeros((6, 4, 2, 8), np.float32)
        page_ids = np.array([2, 5, 3], np.int32)
        k_seq = rng.normal(size=(12, 2, 8)).astype(np.float32)
        jk, _ = jpa.prefill_append(jnp.asarray(kp), jnp.asarray(kp),
                                   jnp.asarray(k_seq), jnp.asarray(k_seq),
                                   jnp.asarray(page_ids), jnp.int32(10),
                                   start=jnp.int32(3))
        tk, tv = torch.zeros(6, 4, 2, 8), torch.zeros(6, 4, 2, 8)
        pa.prefill_append(tk, tv, torch.from_numpy(k_seq),
                          torch.from_numpy(k_seq),
                          torch.from_numpy(page_ids), 10, start=3)
        np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
        assert not tk.numpy()[0].any()
        with pytest.raises(ValueError):
            pa.prefill_append(tk, tv, torch.from_numpy(k_seq),
                              torch.from_numpy(k_seq),
                              torch.from_numpy(page_ids[:2]), 10)

    def test_cow_copy_matches_reference(self):
        rng = np.random.default_rng(6)
        pools = [rng.normal(size=(4, 2, 1, 4)).astype(np.float32)
                 for _ in range(2)]
        jk, jv = jpa._cow_copy_impl([jnp.asarray(p) for p in pools],
                                    [jnp.asarray(-p) for p in pools], 1, 3)
        tk = [torch.from_numpy(p.copy()) for p in pools]
        tv = [torch.from_numpy(-p) for p in pools]
        pa.cow_copy_pages(tk, tv, 1, 3)
        for a, b in zip(tk + tv, list(jk) + list(jv)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        with pytest.raises(ValueError):
            pa.cow_copy_pages(tk, tv, 1, 4)


# ------------------------------- softmax CE ---------------------------------


def _ce_inputs(seed, N, V, dtype):
    rng = np.random.default_rng(seed)
    lg = rng.normal(scale=2.0, size=(N, V))
    lab = rng.integers(0, V, N).astype(np.int32)
    lab[::7] = -100      # ignore_index
    lab[3::11] = V       # past the vocabulary
    dnll = rng.normal(size=N).astype(np.float32)
    jl, tl = _pair(lg, dtype)
    return (jl, jnp.asarray(lab), jnp.asarray(dnll)), \
        (tl, torch.from_numpy(lab), torch.from_numpy(dnll))


class TestSoftmaxCE:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_matches_pallas_interpret(self, dtype):
        """nll, lse and dlogits against both Pallas kernels in the
        interpreter, ragged in rows and vocabulary (N = 96, V = 5000 with
        the static 128 x 2048 blocks), labels -100 and V included. lse is
        6-15 here: atol 1e-4 (1e-5 of it) covers a 5000-term fp32 sum in
        another order; dlogits of bf16 logits are bf16 in both, compared
        at 2e-2."""
        (jl, jlab, jdn), (tl, tlab, tdn) = _ce_inputs(0, 96, 5000, dtype)
        jnll, jlse = jsce._ce_fwd_pallas(jl, jlab, interpret=True)
        nll, lse = sce.softmax_ce_fwd(tl, tlab)
        assert nll.dtype == lse.dtype == torch.float32
        # label V falls inside the TPU kernel's padded last vocab block and
        # picks its -1e30 fill (nll = lse + 1e30, which the caller masks);
        # the port reads nothing for any out-of-range label: nll = lse
        past = (tlab >= 5000).numpy()
        np.testing.assert_allclose(_np(nll)[~past], _np(jnll)[~past],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(_np(lse), _np(jlse), atol=1e-4, rtol=0)
        oob = (tlab < 0) | (tlab >= 5000)
        assert past.any() and torch.equal(nll[oob], lse[oob])
        jdl = jsce._ce_bwd_pallas(jl, jlab, jlse, jdn, interpret=True)
        dl = sce.softmax_ce_bwd(tl, tlab, lse, tdn)
        assert dl.dtype == TDT[dtype]
        np.testing.assert_allclose(_np(dl), _np(jdl), atol=TOL[dtype],
                                   rtol=0)

    def test_function_backward_with_an_expanded_cotangent(self):
        """nll.sum() sends a stride-0 cotangent; the Function's gradient is
        softmax - onehot, and the plain versions count."""
        (_, _, _), (tl, tlab, _) = _ce_inputs(1, 16, 300, "float32")
        x = tl.clone().requires_grad_(True)
        before = dict(sce._stats), dict(sce._bwd_stats)
        nll = sce.fused_softmax_ce(x.reshape(2, 8, 300), tlab.reshape(2, 8))
        assert nll.shape == (2, 8)
        # a view of the Function's output
        assert nll.grad_fn.next_functions[0][0]._forward_cls \
            is sce.SoftmaxCEFunction
        nll.sum().backward()
        p = torch.softmax(tl, -1)
        valid = (tlab >= 0) & (tlab < 300)
        onehot = torch.zeros_like(p)
        onehot[valid, tlab[valid].long()] = 1.0
        torch.testing.assert_close(x.grad, p - onehot, atol=1e-6, rtol=0)
        assert sce._stats["plain"] == before[0]["plain"] + 1
        assert sce._bwd_stats["plain"] == before[1]["plain"] + 1
        assert sce._stats["kernel"] == before[0]["kernel"]

    def test_cross_entropy_takes_the_function(self):
        x = torch.randn(4, 10, requires_grad=True)
        lab = torch.tensor([1, -100, 3, 10])
        before = sce._stats["plain"]
        loss = F.cross_entropy(x, lab)
        assert sce._stats["plain"] == before + 1
        loss.backward()
        assert x.grad[1].abs().max() == 0 and x.grad[3].abs().max() == 0

    @pytest.mark.parametrize("case", ["rank", "strided", "fp16", "labels64",
                                      "labels_shape"])
    def test_kernel_argument_checks_raise(self, case):
        x, lab = torch.ones(4, 10), torch.zeros(4, dtype=torch.int32)
        if case == "rank":
            x = torch.ones(4, 2, 5)
        elif case == "strided":
            x = torch.ones(10, 4).t()
        elif case == "fp16":
            x = x.half()
        elif case == "labels64":
            lab = lab.long()
        else:
            lab = torch.zeros(3, dtype=torch.int32)
        with pytest.raises(ValueError):
            sce.check_args(x, lab)
        sce.check_args(torch.ones(4, 10), torch.zeros(4, dtype=torch.int32))
