"""The port stands alone: no file of paddle_tpu_torch/, not chip_smoke.py and
no tools/profile_torch_*.py imports JAX or anything of the JAX package, and its entry points run on
``cuda`` unless asked for the CPU (they raise, rather than carry on
quietly on the CPU, where no card is present)."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch import _native, _platform
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models.gpt import GPT, GPTConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    tools = sorted((REPO / "tools").glob("profile_torch_*.py"))
    return files + [REPO / "chip_smoke.py"] + tools


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    names = {p.name for p in _port_files()}
    assert len(names) > 10 and {"profile_torch_serving.py",
                                "profile_torch_train.py"} <= names
    bad = []
    for path in _port_files():
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_the_scan_sees_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom paddle_tpu.models import gpt\n"
                 "import jax.numpy as jnp\n")
    assert {"paddle_tpu.models", "jax.numpy"} <= set(_imported_modules(p))


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _platform.resolve_device()
    with pytest.raises(RuntimeError):
        GPT(GPTConfig.tiny())
    m = GPT(GPTConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError):
        ServingEngine(m, max_len=64)
    assert ServingEngine(m, max_len=64, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _platform.resolve_device() == torch.device("cuda")


def test_kernel_wrappers_refuse_other_devices():
    from paddle_tpu_torch.ops import kernels
    with pytest.raises(RuntimeError):
        kernels.use_kernel(torch.empty(2, device="meta"))
    assert kernels.use_kernel(torch.empty(2)) is False


def test_kernel_build_inputs_and_stale_check(tmp_path, monkeypatch):
    """The build compiles every csrc/*.cu for sm_90a and rebuilds when a
    source is newer than the library; nothing is built at import."""
    names = {p.name for p in _native._sources()}
    assert names == {"layer_norm.cu", "flash_attention.cu",
                     "flash_attention_bwd.cu",
                     "flash_attention_bwd_split.cu", "paged_attention.cu",
                     "softmax_ce.cu", "fused_bn.cu", "fused_conv_bn.cu"}
    assert _native.GENCODE == "arch=compute_90a,code=sm_90a"
    lib = tmp_path / "lib.so"
    monkeypatch.setattr(_native, "_LIB", lib)
    assert _native._stale()
    lib.write_bytes(b"")
    deps = list(_native._sources()) + list(_native._CSRC.glob("*.cuh"))
    newer = max(p.stat().st_mtime for p in deps) + 10
    os.utime(lib, (newer, newer))
    assert not _native._stale()


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA, chip_smoke.py exits non-zero and prints no result;
    alone in a directory (without the port) it fails too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO, env=env)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, str(alone)], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path, env=env)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_the_scan_covers_the_bert_ernie_and_amp_modules():
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    assert {"paddle_tpu_torch/nn/transformer.py",
            "paddle_tpu_torch/models/bert.py",
            "paddle_tpu_torch/models/ernie.py",
            "paddle_tpu_torch/incubate/nn/__init__.py",
            "paddle_tpu_torch/amp/__init__.py",
            "paddle_tpu_torch/ops/_dispatch.py"} <= names


def test_bert_ernie_and_transformer_entry_points_default_to_cuda(
        monkeypatch):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    from paddle_tpu_torch.models import (Bert, BertConfig, ErnieConfig,
                                         ErnieForPretraining)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: Bert(BertConfig.tiny(), **kw),
                 lambda **kw: ErnieForPretraining(ErnieConfig.tiny(), **kw),
                 lambda **kw: nn.Transformer(32, 4, 1, 1, 64, **kw),
                 lambda **kw: nn.MultiHeadAttention(32, 4, **kw),
                 lambda **kw: FusedTransformerEncoderLayer(32, 4, 64, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        assert next(make(device="cpu").parameters()).device.type == "cpu"
