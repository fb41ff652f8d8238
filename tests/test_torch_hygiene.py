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


EXAMPLES = [ROOT / "examples" / "mnist" / "train_mnist_torch.py",
            ROOT / "examples" / "imagenet" / "train_imagenet_torch.py"]
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                            ROOT / "profile_port.py"] \
    + EXAMPLES


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
# ChainerMN's data-parallel path: the communicators (no gloo in place of
# NCCL, no CPU in place of the card), the exchange, the loop, the model
DP_PATH = sorted((PORT / "communicators").glob("*.py")) + sorted(
    (PORT / "training").glob("*.py")) + [
    PORT / "ops" / "fused.py", PORT / "ops" / "collectives.py",
    PORT / "links" / "batch_normalization.py", PORT / "models" / "resnet.py",
    PORT / "models" / "mlp.py", PORT / "models" / "convert.py",
    PORT / "datasets" / "__init__.py", PORT / "iterators" / "__init__.py",
    PORT / "iterators" / "_convert.py"] + EXAMPLES


@pytest.mark.parametrize("path", TRAINING_PATH,
                         ids=[str(p.relative_to(ROOT)) for p in TRAINING_PATH])
def test_training_path_has_no_fallback(path):
    # no try around the kernels' autograd path, the optimizer or the
    # smoke phases: a failure surfaces, it is never caught and replaced
    tree = ast.parse(path.read_text())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


@pytest.mark.parametrize("path", DP_PATH,
                         ids=[str(p.relative_to(ROOT)) for p in DP_PATH])
def test_dp_path_catches_no_failure(path):
    # a try on this path only ends an iteration (StopIteration) or
    # releases something (finally): no handler catches a failure of
    # NCCL, the card or a step and carries on another way
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Try):
            for h in node.handlers:
                assert isinstance(h.type, ast.Name) \
                    and h.type.id == "StopIteration", \
                    f"{path.relative_to(ROOT)}:{h.lineno} catches " \
                    f"{ast.unparse(h.type) if h.type else 'everything'}"


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


def test_dp_entry_points_need_cuda_unless_cpu_is_named(no_cuda):
    from chainermn_tpu_torch.communicators import (
        LoopbackCommunicator,
        create_communicator,
        init_distributed,
    )
    from chainermn_tpu_torch.models import (
        ResNetConfig,
        init_mlp_numpy,
        init_resnet_numpy,
        mlp_params_from_jax,
        resnet_params_from_jax,
    )

    cfg = ResNetConfig(depth=50, num_classes=4, width=4, dtype="float32")
    params, state = init_resnet_numpy(cfg, 0)
    mlp = init_mlp_numpy([6, 4, 3], 0)
    for call in (lambda: create_communicator(),
                 lambda: LoopbackCommunicator(),
                 lambda: init_distributed(),
                 lambda: resnet_params_from_jax(params, state, cfg),
                 lambda: mlp_params_from_jax(mlp)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    p, s = resnet_params_from_jax(params, state, cfg, device="cpu")
    assert p["conv1"].device.type == "cpu" and p["conv1"].is_contiguous(
        memory_format=torch.channels_last)
    assert mlp_params_from_jax(mlp, device="cpu")[0]["w"].shape == (6, 4)


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

