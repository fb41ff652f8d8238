"""The port's classic ImageNet convnets against the JAX package's (the
counterpart of ``tests/model_tests/test_convnets.py``).

The same numpy parameters and images go through both packages on the
CPU in fp32, at 32 px (``head="gap"``) or batch 1 (the flatten heads at
their native sizes).  Tolerances: logits and the gradients of
``sum(logits²)`` (every aux head included) to 1e-5 relative of each
leaf's largest element (the packages sum the convolutions in other
orders); the ceil-mode and ``SAME`` pools bitwise (a maximum has no
rounding); the parameter shapes and counts exactly.  The port's side
runs on one torch thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from jax import lax

from chainermn_tpu.models import convnets as jc
from chainermn_tpu_torch.models import (
    ConvNetConfig,
    convnet_apply,
    convnet_params_from_jax,
    convnet_to_numpy,
    init_convnet,
    init_convnet_numpy,
)
from chainermn_tpu_torch.models import convert
from chainermn_tpu_torch.models import convnets as tc

ARCHS = ("alex", "nin", "vgg16", "googlenet")
REL = 1e-5
# the JAX package's counts at the native size (jax.eval_shape)
COUNTS = {"alex": 62_378_344, "nin": 7_595_176, "vgg16": 138_357_544,
          "googlenet": 13_378_280}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one CPU thread: at 32 px and batch 2 the
    convolutions are small, and under a busy machine's other test
    workers a thread pool only slows them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _both(arch, head, size, B, seed=0):
    kw = dict(arch=arch, num_classes=10, dtype="float32", head=head,
              image_size=size)
    cfg, jcfg = ConvNetConfig(**kw), jc.ConvNetConfig(**kw)
    tree = init_convnet_numpy(cfg, seed)
    x = np.random.RandomState(seed + 1).randn(B, size, size, 3).astype(
        np.float32)
    return cfg, jcfg, tree, x


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


def _forward_and_grads(arch, head, size, B):
    cfg, jcfg, tree, x = _both(arch, head, size, B)
    aux = arch == "googlenet"

    def jloss(p):
        outs = _outs(jc.convnet_apply(jcfg, p, jnp.asarray(x),
                                      with_aux=aux))
        return sum(jnp.sum(o ** 2) for o in outs), outs

    # jitted: the JAX package's eager GoogLeNet gradient takes half a
    # minute of op dispatch
    (_, jouts), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    params = convnet_params_from_jax(tree, cfg, device="cpu")
    for leaf in pytree.tree_leaves(params):
        leaf.requires_grad_(True)
    outs = _outs(convnet_apply(cfg, params, torch.tensor(x), with_aux=aux))
    sum((o ** 2).sum() for o in outs).backward()
    for o, w in zip(outs, jouts):
        assert o.dtype == torch.float32 and tuple(o.shape) == w.shape
        assert _rel(o.detach().numpy(), np.asarray(w)) <= REL
    got = convnet_to_numpy(pytree.tree_map(lambda t: t.grad, params))
    want = jax.tree.map(np.asarray, jg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and _rel(g, w) <= REL


@pytest.mark.parametrize("arch", ARCHS)
def test_gap_head_at_32px_matches_jax(arch):
    _forward_and_grads(arch, "gap", 32, 2)


@pytest.mark.parametrize("arch", ["alex", "nin"])
def test_flatten_head_at_227_matches_jax(arch):
    cfg, jcfg, tree, x = _both(arch, "flatten", 227, 1)
    want = np.asarray(jax.jit(lambda p, x: jc.convnet_apply(jcfg, p, x))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))
    with torch.no_grad():
        got = convnet_apply(cfg, convnet_params_from_jax(tree, cfg, "cpu"),
                            torch.tensor(x))
    assert got.shape == (1, 10) and _rel(got.numpy(), want) <= REL


def test_googlenet_aux_heads_at_224_match_jax():
    """The reference geometry's aux heads: a 5x5/3 VALID average pool,
    a 1x1 conv, the 2048-wide flatten."""
    cfg, jcfg, tree, x = _both("googlenet", "flatten", 224, 1)
    want = jax.jit(lambda p, x: jc.convnet_apply(
        jcfg, p, x, with_aux=True))(jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(x))
    with torch.no_grad():
        got = convnet_apply(cfg, convnet_params_from_jax(tree, cfg, "cpu"),
                            torch.tensor(x), with_aux=True)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) <= REL
    assert tree["aux_4a"]["fc1"]["w"].shape == (2048, 1024)


@pytest.mark.parametrize("arch", ARCHS)
def test_flatten_head_parameter_shapes_match_jax(arch):
    want = jax.eval_shape(lambda: jc.init_convnet(
        jax.random.PRNGKey(0), jc.ConvNetConfig(arch=arch)))
    # shapes only: np.empty touches no page of the 138 M VGG weights
    got = convert._convnet_tree(ConvNetConfig(arch=arch),
                                lambda path, shape, kind: np.empty(shape))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(got)] \
        == [a.shape for a in jax.tree.leaves(want)]
    assert sum(a.size for a in jax.tree.leaves(got)) == COUNTS[arch]


@pytest.mark.parametrize("size,k,s", [(7, 3, 2), (8, 3, 2), (13, 3, 2),
                                      (14, 3, 2), (9, 2, 2), (28, 3, 2)])
@pytest.mark.parametrize("ceil", [True, False])
def test_pools_match_jax_where_ceil_and_floor_differ(size, k, s, ceil):
    if ceil:
        out = jc._pool_out(size, k, s, True)
        assert out == tc._pool_out(size, k, s, True)
        extra = max((out - 1) * s + k - size, 0)
        pad = [(0, 0), (0, extra), (0, extra), (0, 0)]
    else:
        pad = "SAME"
    x = np.random.RandomState(size).randn(2, size, size, 3).astype(
        np.float32)
    want = np.asarray(lax.reduce_window(
        jnp.asarray(x), -jnp.inf, lax.max, (1, k, k, 1), (1, s, s, 1), pad))
    got = tc._max_pool(torch.tensor(x).permute(0, 3, 1, 2), k, s, ceil)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    if ceil and (size - k) % s:
        # a floor-mode pool would drop the last row
        assert want.shape[1] == (size - k) // s + 2


def test_refusals():
    with pytest.raises(ValueError, match="arch"):
        ConvNetConfig(arch="resnet")
    with pytest.raises(ValueError, match="head"):
        ConvNetConfig(head="avg")
    with pytest.raises(ValueError, match="collapses"):
        init_convnet_numpy(ConvNetConfig(arch="alex", image_size=32))
    with pytest.raises(ValueError, match="224px"):
        init_convnet_numpy(ConvNetConfig(arch="googlenet", image_size=96))
    cfg = ConvNetConfig(arch="alex", head="gap", num_classes=4,
                        image_size=32, dtype="float32")
    params = init_convnet(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="googlenet only"):
        convnet_apply(cfg, params, torch.zeros(1, 32, 32, 3), with_aux=True)
    tree = init_convnet_numpy(cfg, 0)
    tree[0]["w"] = tree[0]["w"][:-1]
    with pytest.raises(ValueError, match="0/w"):
        convnet_params_from_jax(tree, cfg, device="cpu")


def test_bf16_compute_keeps_fp32_parameters_and_logits():
    cfg = ConvNetConfig(arch="nin", head="gap", num_classes=4,
                        image_size=32)
    params = init_convnet(cfg, 0, device="cpu")
    assert all(t.dtype == torch.float32 for t in pytree.tree_leaves(params))
    assert params[0]["w"].is_contiguous(memory_format=torch.channels_last)
    out = convnet_apply(cfg, params, torch.randn(2, 32, 32, 3))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


def test_imagenet_example_alex_matches_the_jax_example(tmp_path,
                                                       monkeypatch):
    """``train_imagenet_torch.py --tiny --arch alex`` (the gap head, fp32,
    32 px, ``sgd(1e-3, momentum=0.9)``) against ``train_imagenet.py``
    from the same weights at world size 1: an epoch of 7 updates of 64
    images, its losses and accuracy to 1e-3 relative (at the default
    rate 0.1 the loss climbs for the first updates and the runs part by
    0.5 % within the epoch)."""
    import importlib.util
    import sys
    from pathlib import Path

    from chainermn_tpu_torch.communicators import init_distributed

    root = Path(__file__).resolve().parent.parent

    def load(rel, name):
        spec = importlib.util.spec_from_file_location(name, root / rel)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    jex = load("examples/imagenet/train_imagenet.py", "jax_imagenet")
    pex = load("examples/imagenet/train_imagenet_torch.py", "port_imagenet")
    argv = ["--tiny", "--arch", "alex", "--batchsize", "64", "--epoch", "1",
            "--lr", "1e-3"]
    monkeypatch.setattr(sys, "argv", ["train_imagenet.py", "--communicator",
                                      "loopback", "--out",
                                      str(tmp_path / "jax")] + argv)
    want = jex.main().log
    jcfg = jc.ConvNetConfig(arch="alex", num_classes=8, dtype="float32",
                            head="gap")
    tree = jax.tree.map(np.asarray,
                        jc.init_convnet(jax.random.PRNGKey(0), jcfg))
    init_distributed(init_method=f"file://{tmp_path / 'store'}",
                     world_size=1, rank=0, device="cpu")
    try:
        run = pex.build(pex.parse_args(argv + ["--device", "cpu", "--out",
                                               str(tmp_path / "port")]),
                        quiet=True, init=tree)
        run.trainer.run()
    finally:
        torch.distributed.destroy_process_group()
    got = run.log.log
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert (g["epoch"], g["iteration"]) == (w["epoch"], w["iteration"])
        for k in ("main/loss", "validation/loss", "validation/accuracy"):
            assert abs(g[k] - w[k]) <= 1e-3 * max(abs(w[k]), 1e-3), \
                (k, g[k], w[k])
