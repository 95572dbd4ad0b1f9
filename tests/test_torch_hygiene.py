"""Boundaries of the PyTorch port: it imports nothing of JAX or of the JAX
package, serves and trains on the GPU unless asked for the CPU, and a tensor
that is not on the CPU never reaches a kernel's plain version."""

import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.ops import _build  # noqa: E402
from ray_tpu_torch.ops import attention as tattn  # noqa: E402
from ray_tpu_torch.ops import decode_attention as tdec  # noqa: E402
from ray_tpu_torch.ops import quantization as tq  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = [
        (os.path.relpath(p, REPO), m)
        for p in files
        for m in _imported_modules(p)
        if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "flax", "optax", "orbax")
    ]
    assert bad == []


def _native_sources():
    out = []
    for root, _, names in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        if os.sep + "build" in root:
            continue
        out += [os.path.join(root, n) for n in names
                if n.endswith((".c", ".cc", ".cpp", ".h", ".cu", ".cuh"))]
    return sorted(out)


def test_port_c_sources_name_nothing_of_the_jax_package():
    """The port's C, C++ and CUDA sources: no ``ray_tpu.`` name (a type
    named so would pickle as the JAX package's) and no path into
    ``ray_tpu/native/`` (that tier is the JAX package's own; the kernels
    may name the TPU kernels they replace)."""
    import re

    files = _native_sources()
    names = {os.path.basename(p) for p in files}
    assert {"hotpath.c", "shm_store.cpp", "io_pool.cpp", "attention.cu"} <= names
    bad = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if re.search(r"\bray_tpu\.|\bray_tpu/native/", line):
                    bad.append((os.path.relpath(path, REPO), i, line.strip()))
    assert bad == []


def test_native_tier_builds_into_a_gitignored_directory():
    from ray_tpu_torch.native import _build as native_build

    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = f.read().split()
    assert os.path.relpath(native_build.BUILD, REPO) + "/" in ignored
    for name in native_build.TARGETS:
        lib, out_dir = native_build.target(name)
        assert os.path.dirname(out_dir) == native_build.BUILD
        assert not os.path.relpath(lib, REPO).startswith("ray_tpu" + os.sep)


def test_importing_the_engine_and_trainer_loads_no_jax():
    code = (
        "import sys, ray_tpu_torch.serve.llm, ray_tpu_torch.convert, ray_tpu_torch.models, "
        "ray_tpu_torch.train, ray_tpu_torch.parallel\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'ray_tpu', 'optax', 'orbax'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_importing_the_training_library_loads_no_jax_or_frameworks():
    """``import ray_tpu_torch.train`` (trainers, controller, predictors,
    the torch backend, the framework trainers) and ``ray_tpu_torch.tune``
    load neither JAX nor a framework the card's machine lacks: pandas,
    tensorflow, transformers, accelerate, the GBDT packages, optuna and
    IPython stay lazy."""
    code = (
        "import sys, ray_tpu_torch.train, ray_tpu_torch.train.torch, "
        "ray_tpu_torch.train.controller, ray_tpu_torch.tune, ray_tpu_torch.util.collective, "
        "ray_tpu_torch.tune.tuner, ray_tpu_torch.tune.controller, "
        "ray_tpu_torch.tune.schedulers, ray_tpu_torch.tune.search, "
        "ray_tpu_torch.tune.experiment, ray_tpu_torch.tune.callback, "
        "ray_tpu_torch.train.gbdt, ray_tpu_torch.train.xgboost, "
        "ray_tpu_torch.train.lightgbm, ray_tpu_torch.train.tensorflow, "
        "ray_tpu_torch.train.huggingface\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu', 'pandas', "
        "'tensorflow', 'transformers', 'accelerate', 'xgboost', 'lightgbm', 'optuna', "
        "'IPython'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_importing_the_serving_front_loads_no_jax():
    code = (
        "import sys, ray_tpu_torch.serve.llm, ray_tpu_torch.serve.disagg, "
        "ray_tpu_torch.observability.metrics, ray_tpu_torch.observability.metric_defs, "
        "ray_tpu_torch.observability.sketch, ray_tpu_torch.observability.events, "
        "ray_tpu_torch.observability.reqtrace, ray_tpu_torch.runtime.device_plane, "
        "ray_tpu_torch.runtime.fake_transfer, ray_tpu_torch.runtime.data_plane, "
        "ray_tpu_torch.runtime.context, ray_tpu_torch.core.config\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu', 'optax', 'orbax'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_server_without_device_refuses_to_fall_back_to_cpu(monkeypatch):
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.runtime import device_plane
    from ray_tpu_torch.serve.llm import LLMServer, OpenAICompatLLMServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=11, d_model=8, n_layers=1, n_heads=2)
    for cls in (LLMServer, OpenAICompatLLMServer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(lambda: (cfg, {}))
    # and with no CUDA device there is no transfer server to offer blocks on
    device_plane.install_transfer_server(None)
    try:
        assert device_plane.transfer_server() is None
        assert device_plane.transfer_address() is None
    finally:
        device_plane.install_transfer_server(None)


def test_engine_without_device_refuses_to_fall_back_to_cpu(monkeypatch):
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.serve.llm import LLMEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(TransformerConfig(vocab_size=11, d_model=8, n_layers=1, n_heads=2), {})


def test_load_model_without_device_refuses_to_fall_back_to_cpu(monkeypatch, tmp_path):
    from ray_tpu_torch.models.checkpoint import load_model, save_model
    from ray_tpu_torch.models.transformer import TransformerConfig

    save_model(str(tmp_path), TransformerConfig(vocab_size=11, d_model=8, n_layers=1, n_heads=2),
               {"embed": torch.zeros(11, 8)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(str(tmp_path))
    _, params = load_model(str(tmp_path), device="cpu")
    assert params["embed"].device.type == "cpu"


def test_transformers_predictor_without_device_refuses_to_fall_back_to_cpu(monkeypatch):
    from ray_tpu_torch.train.huggingface import TransformersPredictor

    class _Logits(torch.nn.Module):
        def forward(self, input_ids):
            return input_ids

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformersPredictor(_Logits())
    assert TransformersPredictor(_Logits(), device="cpu").device.type == "cpu"


def test_gpu_trial_without_a_gpu_refuses_to_run():
    """A trial given a GPU share on a cluster with no GPU raises at its
    start: it neither waits for a card nor runs on the CPU in its place."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune

    ran = []

    def trainable(config):
        ran.append(config)
        tune.report({"ok": 1})

    rt.init(num_cpus=2, num_gpus=0)
    try:
        with pytest.raises(RuntimeError, match="asks for 0.5 GPU and the cluster has none"):
            tune.run(tune.with_resources(trainable, {"GPU": 0.5}), config={},
                     metric="ok", mode="max")
        grid = tune.run(trainable, config={}, metric="ok", mode="max")
    finally:
        rt.shutdown()
    assert ran == [{}] and grid.get_best_result().metrics["ok"] == 1


def test_unported_engine_options_raise():
    """``mesh=`` is ported (tests/test_torch_tp_serve.py); what it takes is
    a ``ray_tpu_torch.parallel.Mesh``, never anything else."""
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = TransformerConfig(vocab_size=11, d_model=8, n_layers=1, n_heads=2)
    with pytest.raises(TypeError, match="ray_tpu_torch.parallel.Mesh"):
        LLMEngine(cfg, {}, device="cpu", mesh=object())


def _no_plain(*a, **k):
    raise AssertionError("a non-CPU tensor reached the plain version")


@pytest.mark.parametrize("op", ["paged", "dense", "flash", "flash_backward", "int8"])
def test_device_tensors_never_reach_the_plain_version(monkeypatch, op):
    """A tensor off the CPU goes to the kernel or raises; here the kernel
    library cannot load (no nvcc), and the plain version must not be run
    in its place, nor a launch counted."""
    monkeypatch.setattr(tdec, "_paged_decode_plain", _no_plain)
    monkeypatch.setattr(tdec, "_decode_plain", _no_plain)
    monkeypatch.setattr(tattn, "_flash_forward_plain", _no_plain)
    for name in ("_flash_backward_plain", "_bwd_dq_plain", "_bwd_dkv_plain"):
        monkeypatch.setattr(tattn, name, _no_plain)
    monkeypatch.setattr(tq, "_int8_matmul_plain", _no_plain)

    def no_library(*a, **k):
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(_build, "library", no_library)
    dev = torch.device("meta")
    q = torch.empty(2, 4, 64, device=dev)
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    counters = (tdec.paged_decode_attention, tdec.decode_attention, tattn.flash_attention_with_lse,
                tattn.flash_attention_backward_dq, tattn.flash_attention_backward_dkv,
                tq.int8_matmul)
    before = [c.launches for c in counters]
    if op == "flash_backward":
        # a forward that "ran" on the device, so the backward is reached
        monkeypatch.setattr(tattn, "_flash_forward_kernel", lambda q, k, v, *a: (
            torch.empty_like(q), torch.empty(q.shape[:3], device=q.device)))
        x = torch.empty(1, 2, 8, 64, device=dev, requires_grad=True)
        out, lse = tattn.flash_attention_with_lse(x, x, x)
    with pytest.raises(RuntimeError):
        if op == "paged":
            pages = torch.empty(5, 16, 2, 64, device=dev)
            tables = torch.zeros(2, 2, dtype=torch.int32, device=dev)
            tdec.paged_decode_attention(q, pages, pages, tables, lengths)
        elif op == "dense":
            cache = torch.empty(2, 2, 32, 64, device=dev)
            tdec.decode_attention(q, cache, cache, lengths)
        elif op == "flash":
            x = torch.empty(1, 2, 8, 64, device=dev)
            tattn.flash_attention(x, x, x)
        elif op == "int8":
            w = torch.empty(64, 32, dtype=torch.int8, device=dev)
            tq.int8_matmul(q[0], w, torch.empty(32, device=dev))
        else:
            torch.autograd.grad((out, lse), x, (torch.ones_like(out), torch.ones_like(lse)))
    assert [c.launches for c in counters] == before


def test_kernel_sources_build_into_a_gitignored_directory():
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = f.read().split()
    assert os.path.relpath(_build.BUILD, REPO) + "/" in ignored
    assert {"attention.cu", "attention_bwd.cu", "decode_attention.cu", "int8_matmul.cu"} <= set(
        os.listdir(_build.CSRC))
    assert "arch=compute_90a,code=sm_90a" in _build.FLAGS


# --------------------------------------------------------------------------
# the host runtime: light imports, workers that never touch the card
# --------------------------------------------------------------------------
_RUNTIME_PARTS = ("__init__.py", "api.py", "exceptions.py", "core", "runtime", "observability",
                  "dashboard", "accelerators", "native", "data", "dag")


def _runtime_files():
    out = []
    for part in _RUNTIME_PARTS:
        path = os.path.join(REPO, "ray_tpu_torch", part)
        if os.path.isdir(path):
            out += [os.path.join(path, n) for n in sorted(os.listdir(path)) if n.endswith(".py")]
        else:
            out.append(path)
    return out


def test_no_runtime_module_imports_torch_at_its_top():
    bad = []
    for path in _runtime_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in tree.body:  # module level only: functions import lazily
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module
                     else [])
            bad += [(os.path.relpath(path, REPO), n) for n in names if n.split(".")[0] == "torch"]
    assert len(_runtime_files()) > 30 and bad == []
    code = (
        "import sys, ray_tpu_torch, ray_tpu_torch.runtime.worker_main, "
        "ray_tpu_torch.runtime.worker_api, ray_tpu_torch.dashboard.reporter, "
        "ray_tpu_torch.data, ray_tpu_torch.data.executor, ray_tpu_torch.dag, "
        "ray_tpu_torch.dag.plan, ray_tpu_torch.runtime.channel_manager, "
        "ray_tpu_torch.runtime.data_plane\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'ray_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_worker_process_runs_the_port_module_hides_the_card_and_loads_no_jax():
    import ray_tpu_torch as rt
    from torch_runtime_tasks import _worker_facts

    rt.init(num_cpus=2)
    try:
        facts = rt.get(rt.remote(_worker_facts).options(execution="process").remote())
    finally:
        rt.shutdown()
    argv = facts["argv"]
    assert facts["pid"] != os.getpid()
    assert argv[1:4] == ["-S", "-m", "ray_tpu_torch.runtime.worker_main"], argv
    assert facts["cuda_visible_devices"] == ""
    assert facts["forbidden"] == []
    assert facts["torch_sees_cuda"] in (None, False)
