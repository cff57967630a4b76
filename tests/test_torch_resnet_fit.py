"""ResNet-50 trained in fp32 through the port's hapi.Model.fit against the
JAX package's, and the port's fp32 conv2d with cuDNN's TF32 off inside
the call, on the CPU.

On a card, PyTorch's default leaves ``torch.backends.cudnn.allow_tf32``
True, so an fp32 ``torch.nn.functional.conv2d`` would take one TF32 pass
where the reference computes in fp32. The port's ``F.conv2d`` switches
the flag off inside an fp32 call, forward and backward, and restores it;
bf16 and fp16 calls leave it alone. The CPU has no TF32, so these tests
read the flag where the convolution runs: the forward through a spy on
``torch.nn.functional.conv2d``, the backward through a dispatch mode that
sees ``aten.convolution_backward``.

The fit: both packages start from the same numpy parameters and buffers
(``utils.convert.load_numpy_params``) and take 3 fp32 Momentum(0.1, 0.9)
steps at B 2, 64x64, 10 classes, on the same batches (shuffle off). The
bounds are those of ResNet's fp32 parity (tests/test_torch_resnet.py):
the first loss, before any update, to 1e-3 of the reference's; the later
ones to 10 % (its bound on the whole gradient in relative L2). The fp32
gradient of this randomly initialised network moves by per cents when
the batch is only reordered, and at B 2 each update compounds that: the
port's own run with the two samples of every batch swapped moves its
third loss by about 1 % (5 % at lr 1e-3, measured), so the test also
shows that this reordered run passes the 10 % bound and not a 1e-3 one.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu import Model as JModel
from paddle_tpu import optimizer as jopt
from paddle_tpu.io import Dataset as JDataset
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.utils.convert import load_numpy_params

B, HW, CLASSES, STEPS = 2, 64, 10, 3
#: the first loss (no update yet), and those after updates
FIRST_RTOL, LATER_RTOL = 1e-3, 0.10


@pytest.fixture()
def cudnn_tf32_on():
    """cuDNN's TF32 flag at PyTorch's default (True) inside; restored."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32 = prev


class FlagAtConv(TorchDispatchMode):
    """Records cuDNN's TF32 flag at each convolution the dispatcher runs:
    {"convolution": [...], "convolution_backward": [...]}."""

    def __init__(self):
        super().__init__()
        self.seen = {"convolution": [], "convolution_backward": []}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.seen:
            self.seen[name].append(torch.backends.cudnn.allow_tf32)
        return func(*args, **(kwargs or {}))


def _conv_inputs(dtype, data_format):
    rng = np.random.default_rng(0)
    shape = (2, 9, 9, 8) if data_format == "NHWC" else (2, 8, 9, 9)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 8, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    return [t.to(dtype).requires_grad_(True) for t in (x, w, b)]


@pytest.mark.parametrize("data_format", ["NHWC", "NCHW"])
def test_conv2d_fp32_runs_with_cudnn_tf32_off(cudnn_tf32_on, monkeypatch,
                                             data_format):
    """With the global flag True, the port's fp32 conv2d calls torch's
    conv2d while the flag reads False, runs its backward's convolution
    with it False too, and leaves it True afterwards."""
    seen = []
    tconv = torch.nn.functional.conv2d

    def spy(*a, **k):
        seen.append(torch.backends.cudnn.allow_tf32)
        return tconv(*a, **k)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    x, w, b = _conv_inputs(torch.float32, data_format)
    y = F.conv2d(x, w, b, stride=2, padding=1, data_format=data_format)
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 is True
    with FlagAtConv() as mode:
        y.sum().backward()
    assert mode.seen["convolution_backward"] == [False]
    assert torch.backends.cudnn.allow_tf32 is True
    assert all(t.grad is not None for t in (x, w, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_conv2d_low_precision_leaves_the_flag(cudnn_tf32_on, monkeypatch,
                                              dtype):
    """bf16 and fp16 convolutions run with the caller's flags untouched."""
    seen = []
    tconv = torch.nn.functional.conv2d

    def spy(*a, **k):
        seen.append(torch.backends.cudnn.allow_tf32)
        return tconv(*a, **k)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    x, w, b = _conv_inputs(dtype, "NHWC")
    with FlagAtConv() as mode:
        F.conv2d(x, w, b, padding=1, data_format="NHWC").float().sum() \
            .backward()
    assert seen == [True]
    assert mode.seen["convolution_backward"] == [True]
    assert torch.backends.cudnn.allow_tf32 is True


def test_conv2d_fp32_gradients_are_autograds(cudnn_tf32_on):
    """The fp32 path's own backward gives torch autograd's gradients bit
    for bit on the CPU (strided, padded, grouped, with a bias)."""
    x, w, b = _conv_inputs(torch.float32, "NCHW")
    w2 = w.detach()[:, :4].clone().requires_grad_(True)
    y = F.conv2d(x, w2, b, stride=2, padding=1, groups=2)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad(y, (x, w2, b), dy)
    ref_y = torch.nn.functional.conv2d(x, w2, b, 2, 1, 1, 2)
    want = torch.autograd.grad(ref_y, (x, w2, b), dy)
    assert torch.equal(y, ref_y)
    assert all(torch.equal(g, r) for g, r in zip(got, want))


# ------------------------------ Model.fit ------------------------------------


def _batch(i):
    rng = np.random.default_rng(100 + i)
    return (rng.normal(size=(HW, HW, 3)).astype(np.float32),
            np.int64(rng.integers(0, CLASSES)))


class DS(Dataset):
    """The batches; `swap`: the two samples of every batch in the other
    order."""

    def __init__(self, swap=False):
        self.swap = swap

    def __len__(self):
        return STEPS * B

    def __getitem__(self, i):
        return _batch(i ^ 1 if self.swap else i)


class JDS(JDataset):
    def __len__(self):
        return STEPS * B

    def __getitem__(self, i):
        x, y = _batch(i)
        return x, np.int32(y)


class Losses:
    """Records each batch's loss (a Callback of either package)."""

    def __init__(self):
        self.losses = []

    def __getattr__(self, name):
        if name.startswith("on_") or name.startswith("set_"):
            return lambda *a, **k: None
        raise AttributeError(name)

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"][0])


def _port_fit(arrays, swap=False):
    net = tresnet.resnet50(num_classes=CLASSES, data_format="NHWC",
                           device="cpu")
    load_numpy_params(net, arrays)
    m = Model(net)
    m.prepare(optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                 parameters=net.parameters()),
              F.cross_entropy)
    rec = Losses()
    m.fit(DS(swap), batch_size=B, epochs=1, shuffle=False, verbose=0,
          callbacks=[rec])
    return rec.losses


def _held(losses, ref, later_rtol):
    """The first loss within FIRST_RTOL of the reference's, the later
    ones within `later_rtol`."""
    rel = np.abs(np.asarray(losses) - ref) / np.abs(ref)
    return bool(rel[0] <= FIRST_RTOL and np.all(rel[1:] <= later_rtol))


def test_resnet50_model_fit_fp32_matches_reference():
    """hapi.Model(resnet50(NHWC)).prepare(Momentum(0.1, 0.9),
    cross_entropy).fit in fp32 (as Model builds its step): 3 losses
    against the reference's from the same parameters and buffers, and 32
    plain conv1x1_stats runs a step (every stride-1 1x1 conv of the
    bottlenecks; the CPU runs the plain versions). The port's run on the
    reordered batches passes the same bounds, and would fail 1e-3 on the
    later losses."""
    paddle.seed(0)
    jnet = jresnet.resnet50(num_classes=CLASSES, data_format="NHWC")
    arrays = {k: np.asarray(v.data) for k, v in jnet.named_parameters()}
    arrays.update({k: np.asarray(v.data) for k, v in jnet.named_buffers()})
    jm = JModel(jnet)
    jm.prepare(jopt.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=jnet.parameters()),
               JF.cross_entropy)
    jrec = Losses()
    jm.fit(JDS(), batch_size=B, epochs=1, shuffle=False, verbose=0,
           callbacks=[jrec])

    kernels.reset_stats()
    losses = _port_fit(arrays)
    st = kernels.all_stats()
    kernels.reset_stats()
    assert st["conv1x1_stats"] == {"kernel": 0, "plain": 32 * STEPS}
    for name in ("fused_bn_fwd", "fused_bn_bwd_reduce", "fused_bn_bwd_dx"):
        assert st[name] == {"kernel": 0, "plain": 49 * STEPS}, name
    ref = np.asarray(jrec.losses)
    print(f"\nport {losses}\nreference {jrec.losses}")
    assert len(losses) == len(ref) == STEPS
    assert _held(losses, ref, LATER_RTOL)
    # what the bound sits above: the port's own order noise
    swapped = _port_fit(arrays, swap=True)
    print(f"port, samples swapped {swapped}")
    assert _held(swapped, ref, LATER_RTOL)
    assert not _held(swapped, ref, FIRST_RTOL)
