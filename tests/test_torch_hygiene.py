"""Rules the port keeps: it imports nothing of JAX or the JAX package,
its entry points never fall back to the CPU on their own, and the CUDA
wrapper never falls back to its plain version."""

import ast
import re
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
            ROOT / "examples" / "mnist" / "train_mnist_model_parallel_torch.py",
            ROOT / "examples" / "imagenet" / "train_imagenet_torch.py",
            ROOT / "examples" / "imagenet"
            / "train_imagenet_large_batch_torch.py",
            ROOT / "examples" / "transformer" / "train_lm_torch.py",
            ROOT / "examples" / "transformer" / "generate_torch.py",
            ROOT / "examples" / "seq2seq" / "seq2seq_torch.py"]
# the test helpers the port's drills import or run in children
TEST_HELPERS = [ROOT / "tests" / "test_torch_world.py",
                ROOT / "tests" / "_torch_fault_worker.py"]
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                            ROOT / "profile_port.py"] \
    + EXAMPLES + TEST_HELPERS


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


# the sequence axis: the mesh, the ring, Ulysses and seq-KV decoding
SEQ_PATH = [PORT / "parallel" / "mesh.py",
            PORT / "parallel" / "ring_attention.py",
            PORT / "parallel" / "ulysses.py", PORT / "models" / "decoding.py"]
# the model axis: the Megatron operators and the layout's converter
TP_PATH = [PORT / "parallel" / "tensor.py", PORT / "models" / "convert.py"]
# the pipe axis: the schedules
PP_PATH = [PORT / "parallel" / "pipeline.py"]
# the expert axis: the MoE layer and its exchange
EP_PATH = [PORT / "parallel" / "expert.py"]
# the data axis's sharding: FSDP's gathers and the sharded-state layer
FSDP_PATH = [PORT / "parallel" / "fsdp.py",
             PORT / "parallel" / "sharded_state.py"]
# the serving options: int8 weights and the decoders (decoding.py is in
# SEQ_PATH)
SERVE_PATH = [PORT / "models" / "quantization.py"]
# the other example models: seq2seq, the n-step RNN, the convnets
MODELS_PATH = [PORT / "models" / "seq2seq.py",
               PORT / "links" / "n_step_rnn.py",
               PORT / "models" / "convnets.py"]
TRAINING_PATH = [PORT / "models" / "transformer.py",
                 PORT / "training" / "optimizers.py",
                 ROOT / "chip_smoke.py"] + SEQ_PATH + TP_PATH + PP_PATH \
    + EP_PATH + FSDP_PATH + SERVE_PATH + MODELS_PATH
# ChainerMN's data-parallel path: the communicators (no gloo in place of
# NCCL, no CPU in place of the card), the exchange, the loop, the model
# (less the store's control-plane channel, whose handlers are the fault
# layer's, listed in FAULT_HANDLERS)
DP_PATH = sorted(p for p in (PORT / "communicators").glob("*.py")
                 if p.name != "_obj_channel.py") + sorted(
    (PORT / "training").glob("*.py")) + [
    PORT / "ops" / "fused.py", PORT / "ops" / "collectives.py",
    PORT / "ops" / "point_to_point.py",
    PORT / "links" / "multi_node_chain_list.py",
    PORT / "links" / "batch_normalization.py", PORT / "models" / "resnet.py",
    PORT / "models" / "mlp.py", PORT / "models" / "convert.py",
    PORT / "datasets" / "__init__.py", PORT / "iterators" / "__init__.py",
    PORT / "iterators" / "_convert.py"] + SEQ_PATH + TP_PATH[:1] + PP_PATH \
    + EP_PATH + FSDP_PATH + SERVE_PATH + MODELS_PATH + EXAMPLES


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


def test_window_capture_has_no_eager_fallback():
    # fuse_steps on the card: the window runs eagerly once, as the
    # warm-up before any capture; a capture that fails raises out of
    # __call__, which has no other path to the steps
    tree = ast.parse((PORT / "training" / "updater.py").read_text())
    cls = next(n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
               and n.name == "_GraphedSteps")
    assert not any(isinstance(n, ast.Try) for n in ast.walk(cls))
    call = next(n for n in cls.body if isinstance(n, ast.FunctionDef)
                and n.name == "__call__")
    runs = [n for n in ast.walk(call) if isinstance(n, ast.Call)
            and ast.unparse(n.func) == "self._run"]
    assert len(runs) == 1
    warm = next(n for n in call.body if isinstance(n, ast.If))
    assert ast.unparse(warm.test) == "not self.warm" and runs[0] in list(
        ast.walk(warm))
    capture = next(n for n in cls.body if isinstance(n, ast.FunctionDef)
                   and n.name == "_capture")
    assert any(isinstance(n, ast.With) and "torch.cuda.graph" in
               ast.unparse(n.items[0].context_expr)
               for n in ast.walk(capture))
    # the plain loop runs only where the CPU is named: fuse_steps'
    # device defaults to the card, and the updater passes its own device
    fuse = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "fuse_steps")
    assert [ast.unparse(d) for d in fuse.args.kw_defaults][1] == "None"
    branch = next(n for n in fuse.body if isinstance(n, ast.If))
    assert ast.unparse(branch.test) == \
        "resolve_device(device).type == 'cpu'"
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and ast.unparse(n.func) == "fuse_steps"]
    assert calls and all(
        {k.arg: ast.unparse(k.value) for k in c.keywords}.get("device")
        == "self.device" for c in calls)


# The fault-tolerance layer: every handler it holds, by file, and why it
# may catch.  A file not named here, or a handler not in its list, fails.
FAULT_HANDLERS = {
    "utils/serialization.py": {
        "FileNotFoundError": "re-raised: a file a peer's GC removed is "
                             "gone, not damaged",
        "_UNREADABLE": "numpy, zip and pickle read errors, re-raised as "
                       "SnapshotCorruptError",
        "ForeignSnapshotError": "re-raised with the file's path",
    },
    "extensions/checkpoint.py": {
        "SnapshotCorruptError": "the fallback: quarantine the file, vote "
                                "the set down, resume from an older one",
        "FileNotFoundError": "a file a peer's GC removed votes its set "
                             "down, and is not removed twice",
        "OSError": "a failed quarantine rename must not leave the "
                   "verdict allgather the peers wait in",
        "BaseException": "the writer thread's error box, re-raised at "
                         "the join",
        "ShardSetError": "a shard-only set whose parts do not tile votes "
                         "the set down, and resume falls back (the JAX "
                         "package's rule)",
    },
    "extensions/watchdog.py": {
        "Exception": "the on_stall callback: a failing callback must not "
                     "crash a healthy job (the JAX package's rule)",
        "dist.DistError": "the peers' heartbeat read: the store's host "
                          "(rank 0) died, which stalls every peer in the "
                          "report and keeps the local check running",
    },
    # the host feed
    "iterators/prefetch.py": {
        "queue.Full": "the worker's bounded put polls the stop flag",
        "queue.Empty": "the consumer's take and the halt's drain poll "
                       "the worker",
        "StopIteration": "the base iterator's end, delivered as the "
                         "stream's end",
        "BaseException": "the worker's error box, re-raised from next() "
                         "in the consumer",
        "RuntimeError": "close() warns and abandons a worker blocked in "
                        "the base iterator's next() (the JAX package's "
                        "rule) instead of hanging shutdown; state_dict "
                        "and reset raise",
    },
    # the control plane over the world's store, and the two sinks
    "communicators/_obj_channel.py": {
        "dist.DistError": "a transient store error (a network error, a "
                          "reset connection, a broken pipe) retried, "
                          "bounded; anything else, a timeout included, "
                          "re-raised",
        "StaleGenerationError": "re-raised once the refused message is "
                                "consumed (its keys deleted)",
        "ValueError": "a status key (a resize intent) or the membership "
                      "file that is not JSON reads as absent (the JAX "
                      "package's rule)",
        "UnicodeDecodeError": "a status key that is not text reads as "
                              "absent",
        "OSError": "a membership file that cannot be read reads as "
                   "absent",
    },
    "utils/metrics.py": {
        "OSError": "a full disk must never end training: the Prometheus "
                   "textfile's flush is skipped (the JAX package's rule)",
    },
    "utils/telemetry.py": {
        "OSError": "a full disk ends the trace's stream, or skips a "
                   "MetricsExport line, never training",
        "ValueError": "a malformed CHAINERMN_TPU_TRACE_CAPACITY at import "
                      "falls back to the default capacity",
        "TypeError": "an observation that is not a number is left out of "
                     "the MetricsExport line",
    },
    "native/__init__.py": {
        "FileNotFoundError": "no g++: re-raised as RuntimeError naming the "
                             "build",
        "RuntimeError": "native_available() answers False; load() and "
                        "NativeBatchIterator raise",
        "OSError": "native_available() answers False for a library that "
                   "will not load; load() raises",
    },
}
FAULT_PATH = sorted((PORT / "extensions").glob("*.py")) + [
    PORT / "utils" / "serialization.py", PORT / "testing.py",
    PORT / "iterators" / "prefetch.py", PORT / "native" / "__init__.py",
    PORT / "communicators" / "_obj_channel.py",
    PORT / "utils" / "metrics.py", PORT / "utils" / "telemetry.py"]


def _handler_names(h):
    if h.type is None:
        return ["everything"]
    kinds = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
    return [ast.unparse(k) for k in kinds]


@pytest.mark.parametrize("path", FAULT_PATH,
                         ids=[str(p.relative_to(ROOT)) for p in FAULT_PATH])
def test_fault_layer_catches_only_what_it_names(path):
    allowed = FAULT_HANDLERS.get(str(path.relative_to(PORT)), {})
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Try):
            for h in node.handlers:
                for name in _handler_names(h):
                    assert name in allowed, \
                        f"{path.relative_to(ROOT)}:{h.lineno} catches {name}"


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
                 lambda: training.fuse_steps(lambda c, x: (c + x, x), 2),
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
    carry, seen = training.fuse_steps(lambda c, x: (c + x, x), 2,
                                      device="cpu")(torch.zeros(()),
                                                    torch.ones(()))
    assert float(carry) == 2.0 and seen.shape == (2,)


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



def _queue_a_numbers():
    """The A-numbers ROADMAP's Queue A labels its items with."""
    text = (ROOT / "ROADMAP.md").read_text()
    queue = text[text.index("### Queue A"):text.index("### Queue B")]
    return {int(n) for n in re.findall(r"\*\*A(\d+):", queue)}


def _named_items(path):
    """Every Queue A item number ``path`` names: in its text (adjacent
    string literals joined, whitespace folded), and in the
    ``_not_ported`` calls and ``(what, condition, item)`` tables that
    build a message from a number."""
    src = path.read_text()
    text = re.sub(r"\s+", " ", re.sub(r"[\"']\s*\n\s*f?[\"']", "", src))
    for m in re.finditer(r"Queue A items? (\d+)((?:,? and \d+|, \d+)*)",
                         text):
        yield int(m.group(1))
        yield from (int(n) for n in re.findall(r"\d+", m.group(2)))
    if "_not_ported" not in src:
        return
    for node in ast.walk(ast.parse(src)):
        args = None
        if isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "_not_ported":
            args = node.args
        elif isinstance(node, ast.Tuple) and len(node.elts) == 3 \
                and isinstance(node.elts[0], ast.Constant) \
                and isinstance(node.elts[0].value, str):
            args = node.elts
        if args and isinstance(args[-1], ast.Constant) \
                and isinstance(args[-1].value, int):
            yield args[-1].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_queue_a_items_are_a_numbers(path):
    # "item N" in a message is AN: a number ROADMAP does not label an
    # item with points a user at nothing, or at the wrong work
    known = _queue_a_numbers()
    assert {1, 3, 11, 12} <= known
    for n in _named_items(path):
        assert n in known, f"{path.relative_to(ROOT)} names Queue A " \
            f"item {n}; ROADMAP labels A{sorted(known)}"


def test_queue_a_item_scan_sees_split_messages(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text('raise E("x (ROADMAP Queue "\n    "A item 7)")\n'
                     '# Queue A items 2 and 10\n'
                     'def _not_ported(w, i): ...\n'
                     'T = (("a", True, 5),)\n_not_ported("b", 9)\n')
    assert sorted(_named_items(probe)) == [2, 5, 7, 9, 10]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_path_under_the_jax_package(path):
    # a path into chainermn_tpu/ is allowed only as a file:line
    # reference (the kernel table's "replaces"), never as a component
    # to join, so nothing of the JAX package is opened or loaded
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and not re.search(r"\s", node.value):
            v = node.value
            assert v != "chainermn_tpu" and "_libcmn_native" not in v, \
                f"{path.relative_to(ROOT)}:{node.lineno} {v!r}"
            if "chainermn_tpu/" in v:
                assert re.fullmatch(r"chainermn_tpu/[\w/]+\.py:\d*", v), \
                    f"{path.relative_to(ROOT)}:{node.lineno} {v!r}"


def test_new_model_entry_points_need_cuda_unless_cpu_is_named(no_cuda):
    from chainermn_tpu_torch.models import (
        ConvNetConfig,
        Seq2seqConfig,
        convnet_params_from_jax,
        init_convnet,
        init_convnet_numpy,
        init_seq2seq,
        init_seq2seq_numpy,
        seq2seq_params_from_jax,
    )

    s2s = Seq2seqConfig(src_vocab=8, tgt_vocab=8, d_embed=4, d_hidden=4,
                        n_layers=1)
    conv = ConvNetConfig(arch="nin", head="gap", num_classes=4,
                         image_size=32)
    for call in (lambda: init_seq2seq(s2s),
                 lambda: seq2seq_params_from_jax(init_seq2seq_numpy(s2s),
                                                 s2s),
                 lambda: init_convnet(conv),
                 lambda: convnet_params_from_jax(init_convnet_numpy(conv),
                                                 conv)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert init_seq2seq(s2s, device="cpu")["proj"]["w"].device.type == "cpu"
    assert init_convnet(conv, device="cpu")[0]["w"].device.type == "cpu"
