"""The CPU's proof of the fp32 flash kernels' error budget on the card.

On an H100 the fp32 flash forward and backwards at head dim 64 and 128
run on the TF32 tensor cores in a 3xTF32 split (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cuh``, ``csrc/mma.cuh``): each operand x is
split into hi = x rounded to the
nearest TF32 (10 explicit mantissa bits, ties away from zero:
``cvt.rna.tf32.f32``) and lo = x - hi with its 13 low bits cleared, and
each product a b is taken as hi hi + hi lo + lo hi, in fp32. No CUDA runs
here, so this file emulates that arithmetic in torch (TF32 rounding by
bit masking) for both products of attention, S = Q K^T and O = P V, and
holds the result against the JAX package's fp32 ``flash_attention`` on
the same seeded numpy inputs: within 1e-4, the fp32 gate the card's
kernel is held to against its plain version (``chip_smoke.TOL``). The
backward's five products (S = Q K^T, dP = dO V^T, dV = P^T dO,
dK = dS^T Q, dQ = dS K, with dS = P (dP - delta)) are emulated the same
way and held against ``jax.vjp`` of the same function, within 1e-4 of
each gradient's scale (``chip_smoke.bwd_tol``). A single TF32 pass (one
product of the rounded operands) on the same inputs errs by more than
the split: only that order is asserted.

The fp32 1x1 conv + BN statistics (``csrc/fused_conv_bn.cu``, design
"wgmma-3xtf32") takes the same split on its product y = x w^T, in its own
order: for each k8 slice, lo hi, hi lo, then hi hi into one accumulator,
a chain restarting every 256 of Cin and its sum added into fp32; sum and
sumsq are of y as stored. The emulation is held against the JAX
package's ``_conv1x1_stats_pallas(interpret=True)`` within phase 3's
fp32 gate (``chip_smoke.conv_ratio``): y to 1e-5 of |y| plus 1e-5 of
|x| |w|^T, the sums to 1e-5 of the sums of |y| and y^2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import fused_conv_bn as jfcb
from paddle_tpu_torch.models.gpt import GPTConfig

GATE = 1e-4


def tf32(x):
    """x rounded to the nearest TF32, ties away from zero: add half a unit
    of the 13 dropped bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate(x):
    """x with its 13 low mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    """(hi, lo) as ``csrc/mma.cuh:split_tf32`` forms them: hi = x rounded
    to TF32, lo = x - hi truncated to TF32."""
    hi = tf32(x)
    return hi, truncate(x - hi)


def mm_3xtf32(a, b):
    """a @ b from three TF32 products in fp32, the small ones first."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(a, b):
    """a @ b from one product of the TF32-rounded operands."""
    return tf32(a) @ tf32(b)


def attention(q, k, v, mm, causal=True):
    """[B, L, H, D] fp32 attention with both products taken by `mm`, the
    kernel's order: unnormalised P = exp(S - max), O = (P V) / sum(P)."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = mm(qh, kh.transpose(-1, -2)) / np.sqrt(q.shape[-1])
    if causal:
        L = q.shape[1]
        s = s.masked_fill(torch.ones(L, L, dtype=torch.bool).triu(1),
                          float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = mm(p, vh) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 2.0 ** -11 - 2.0 ** -20, -(1.0 + 2.0 ** -11),
                      3.0e-20, 0.0])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                         -(1.0 + 2.0 ** -10), tf32(torch.tensor([3.0e-20]))[0],
                         0.0])
    assert torch.equal(tf32(x), want)
    r = tf32(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert not (r.view(torch.int32) & 0x1FFF).any()
    hi, lo = split(torch.tensor([np.pi], dtype=torch.float32))
    assert abs(float(hi + lo) - np.pi) < 2.0 ** -21 * np.pi


def test_tf32_split_keeps_nan():
    """Half a unit added to 0x7fffffff (the card's canonical NaN) or to
    0xffffffff carries into the sign and gives a zero, so hi loses such a
    NaN; lo, x - hi truncated, keeps every NaN, so a product with that
    operand is NaN. An infinity stays itself in hi."""
    x = torch.tensor([0x7FFFFFFF, -1, 0x7F800001, 0x7FC00000, 0x7F800000,
                      -0x800000], dtype=torch.int32).view(torch.float32)
    hi, lo = split(x)
    assert not hi[:2].isnan().any()
    assert lo[:4].isnan().all()
    assert (hi * 1.0 + lo * 1.0)[:4].isnan().all()
    assert hi[4] == float("inf") and hi[5] == float("-inf")


@pytest.mark.parametrize("shape", [
    # GPTConfig.tiny()'s heads: B 2, L its 128 positions, H 4, D 16. The
    # card runs D 16 on CUDA cores: this case checks the arithmetic only
    "tiny",
    # tiny's hidden width as one head, D 64: a shape the 3xTF32 kernel
    # takes
    "tiny-d64",
    (1, 256, 2, 64)])
def test_3xtf32_attention_within_the_fp32_gate_of_jax(shape):
    if shape in ("tiny", "tiny-d64"):
        cfg = GPTConfig.tiny()
        heads = cfg.num_heads if shape == "tiny" else 1
        shape = (2, cfg.max_position_embeddings, heads,
                 cfg.hidden_size // heads)
    rng = np.random.default_rng(sum(shape))
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    split_err = float(np.abs(
        attention(tq, tk, tv, mm_3xtf32).numpy() - want).max())
    single_err = float(np.abs(
        attention(tq, tk, tv, mm_tf32).numpy() - want).max())
    assert split_err <= GATE
    assert single_err > split_err


def attention_bwd(q, k, v, do, mm, causal=False, mask=None):
    """(dq, dk, dv) of [B, L, H, D] fp32 attention with the five products
    taken by `mm`, as the kernels order them: lse and O from the forward's
    products, delta = rowsum(dO * O) in fp32, P = exp(S - lse), 0 where
    the causal triangle or the bool mask ([B|1, 1, Lq|1, Lk], True =
    attend) hides a pair, dS = P (dP - delta)."""
    qh, kh, vh, dh = (t.transpose(1, 2) for t in (q, k, v, do))
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = mm(qh, kh.transpose(-1, -2)) * scale
    L = q.shape[1]
    keep = torch.ones(L, L, dtype=torch.bool)
    if causal:
        keep = keep.tril()
    if mask is not None:
        keep = keep & mask
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    lse = m + torch.log(p.sum(-1, keepdim=True))
    o = mm(p, vh) / p.sum(-1, keepdim=True)
    delta = (dh * o).sum(-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - lse), 0.0)
    ds = p * (mm(dh, vh.transpose(-1, -2)) - delta)
    dv = mm(p.transpose(-1, -2), dh)
    dk = mm(ds.transpose(-1, -2), qh) * scale
    dq = mm(ds, kh) * scale
    return tuple(t.transpose(1, 2) for t in (dq, dk, dv))


def _masks(kind, B, L, rng):
    """None, or the bool mask of `kind` as numpy: "pad" [B, 1, 1, L] (each
    row's length in L/2..L), "tril_pad" [B, 1, L, L] (the same and the
    lower triangle), the masks Transformer-base's attention takes."""
    if kind is None:
        return None
    lens = rng.integers(L // 2, L + 1, B)
    m = (np.arange(L)[None, :] < lens[:, None])[:, None, None, :]
    if kind == "tril_pad":
        m = m & np.tril(np.ones((L, L), dtype=bool))
    return m


@pytest.mark.parametrize("causal,kind", [
    (True, None), (False, None), (False, "pad"), (False, "tril_pad")])
def test_3xtf32_backward_within_the_fp32_gate_of_jax(causal, kind):
    """The one-pass kernel's and the split pair's arithmetic (both take
    the same five products) at B 2, L 128, H 2, D 64, against jax.vjp of
    the JAX package's fp32 flash_attention on the same inputs."""
    shape = (2, 128, 2, 64)
    rng = np.random.default_rng(7 + causal + 2 * (kind is not None))
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    mask = _masks(kind, shape[0], shape[1], rng)
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, mask=jm, causal=causal), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tm = None if mask is None else torch.from_numpy(mask)

    def errs(mm):
        got = attention_bwd(tq, tk, tv, tdo, mm, causal, tm)
        return [float(np.abs(g.numpy() - w).max())
                / (GATE * max(1.0, float(np.abs(w).max())))
                for g, w in zip(got, want)]

    split, single = errs(mm_3xtf32), errs(mm_tf32)
    assert max(split) <= 1.0, split
    assert all(b > a for a, b in zip(split, single)), (split, single)


#: the conv kernel's chain: its accumulators are added into fp32 every
#: kFlushTiles (8) stages of 32 of Cin
CONV_CHAIN = 256
CONV_RTOL = SUM_RTOL = 1e-5


def conv_3xtf32(x, w):
    """y = x @ w^T [R, Cout] as the fp32 1x1 conv kernel forms it: x and w
    split, each k8 slice's three products (lo hi, hi lo, hi hi) added in
    turn into one fp32 accumulator, which restarts every CONV_CHAIN of Cin
    and is added into the result."""
    (xh, xl), (wh, wl) = split(x), split(w)
    y = torch.zeros(x.shape[0], w.shape[0])
    for c0 in range(0, x.shape[1], CONV_CHAIN):
        acc = torch.zeros_like(y)
        for k in range(c0, min(c0 + CONV_CHAIN, x.shape[1]), 8):
            sl = slice(k, k + 8)
            acc = acc + xl[:, sl] @ wh[:, sl].t()
            acc = acc + xh[:, sl] @ wl[:, sl].t()
            acc = acc + xh[:, sl] @ wh[:, sl].t()
        y = y + acc
    return y


def conv_ratio(x, w, y, s, ss, want):
    """Worst error / phase 3's fp32 gate of (y, sum, sumsq) against the
    reference's (jy, js, jss), the sums being of y as stored."""
    jy, js, jss = (torch.from_numpy(np.array(a)) for a in want)
    terms = x.abs() @ w.abs().t()
    ratio = float(((y - jy).abs()
                   / (CONV_RTOL * jy.abs() + SUM_RTOL * terms)).max())
    for got, ref, mag in ((s, js, y.abs().sum(0)),
                          (ss, jss, (y * y).sum(0))):
        ratio = max(ratio, float(((got - ref).abs()
                                  / (SUM_RTOL * mag + 1e-30)).max()))
    return ratio


@pytest.mark.parametrize("Cin,Cout", [
    (64, 256), (512, 128), (2048, 512),
    # Cin off the kernel's 32-wide stage and the chain
    (200, 64)])
def test_3xtf32_conv1x1_within_the_fp32_gate_of_jax(Cin, Cout):
    """R 264 (off every row tile): the emulated kernel's y and statistics
    within phase 3's fp32 gate of the JAX package's Pallas kernel
    (interpreted); a single TF32 pass on the same inputs errs by more."""
    R = 264
    rng = np.random.default_rng(Cin + Cout)
    x = rng.standard_normal((R, Cin)).astype(np.float32)
    w = (rng.standard_normal((Cout, Cin)) / np.sqrt(Cin)).astype(np.float32)
    want = jfcb._conv1x1_stats_pallas(jnp.asarray(x), jnp.asarray(w.T),
                                      interpret=True)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)

    def ratio(y):
        return conv_ratio(tx, tw, y, y.sum(0), (y * y).sum(0), want)

    split_ratio = ratio(conv_3xtf32(tx, tw))
    single_ratio = ratio(mm_tf32(tx, tw.t()))
    assert split_ratio <= 1.0, split_ratio
    assert single_ratio > split_ratio, (split_ratio, single_ratio)
