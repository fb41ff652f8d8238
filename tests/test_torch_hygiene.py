"""Rules the port keeps: it imports nothing of JAX or the JAX package,
its entry points never fall back to the CPU on their own, and the CUDA
wrapper never falls back to its plain version."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from chainermn_tpu_torch import _build, resolve_device, training
from chainermn_tpu_torch.models import (
    TransformerConfig,
    init_numpy_params,
    make_forward_fn,
    make_generate_fn,
    make_train_step,
    make_value_and_grad_fn,
    params_from_jax,
)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "chainermn_tpu_torch"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                            ROOT / "profile_port.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "chainermn_tpu", "optax"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_flash_wrapper_has_no_fallback():
    tree = ast.parse((PORT / "ops" / "flash_attention.py").read_text())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


TRAINING_PATH = [PORT / "models" / "transformer.py",
                 PORT / "training" / "optimizers.py", ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", TRAINING_PATH,
                         ids=[str(p.relative_to(ROOT)) for p in TRAINING_PATH])
def test_training_path_has_no_fallback(path):
    # no try around the kernels' autograd path, the optimizer or the
    # smoke phases: a failure surfaces, it is never caught and replaced
    tree = ast.parse(path.read_text())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_cuda_unless_cpu_is_named(no_cuda):
    cfg = TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                            d_head=8, d_ff=32, n_layers=1, max_seq=8,
                            attention="flash", dtype="float32")
    tree = init_numpy_params(cfg, 0)
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: make_forward_fn(cfg),
                 lambda: make_generate_fn(cfg),
                 lambda: make_value_and_grad_fn(cfg),
                 lambda: make_train_step(cfg, training.sgd(0.1)),
                 lambda: params_from_jax(tree, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    params = params_from_jax(tree, cfg, device="cpu")
    toks = np.zeros((1, 8), np.int32)
    assert make_forward_fn(cfg, device="cpu")(params, toks).device.type \
        == "cpu"
    out = make_generate_fn(cfg, device="cpu")(params, toks[:, :2])
    assert out.shape == (1, 8) and out.device.type == "cpu"
    opt = training.sgd(0.1)
    _, _, loss = make_train_step(cfg, opt, device="cpu")(
        params, opt.init(params), toks, toks)
    assert loss.device.type == "cpu"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("flash_fwd")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    with pytest.raises(FileNotFoundError):
        _build.load_library("no_such_kernel")

