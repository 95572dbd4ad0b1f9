"""Boundaries of the PyTorch port: it imports nothing of JAX or of the JAX
package, serves and trains on the GPU unless asked for the CPU, and a tensor
that is not on the CPU never reaches a kernel's plain version."""

import ast
import os
import subprocess
import sys
import threading

import numpy as np
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
_RUNTIME_PARTS = ("__init__.py", "_version.py", "api.py", "exceptions.py", "job_submission.py",
                  "core", "runtime", "observability", "dashboard", "accelerators", "native",
                  "data", "dag", "runtime_env", "usage", "state", "job", "workflow")


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


def test_importing_jobs_workflows_state_and_the_head_loads_no_jax_or_torch():
    """The job, workflow, state, runtime-env and usage libraries and the
    dashboard head load neither JAX nor the JAX package, nor torch: a job
    driver or a head pays for torch only where it touches the card."""
    code = (
        "import sys, ray_tpu_torch.job, ray_tpu_torch.job_submission, "
        "ray_tpu_torch.workflow, ray_tpu_torch.state, ray_tpu_torch.runtime_env, "
        "ray_tpu_torch.usage, ray_tpu_torch.dashboard, ray_tpu_torch.dashboard.ui, "
        "ray_tpu_torch._version\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'ray_tpu'))\n"
        "assert not bad, bad\n"
        "import ray_tpu_torch.air, ray_tpu_torch.air.integrations.mlflow, "
        "ray_tpu_torch.air.integrations.wandb\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu', 'mlflow', 'wandb'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_lifted_entry_points_no_longer_raise_and_head_port_still_does(monkeypatch):
    """``include_dashboard``, usage stats on, ``.options(runtime_env=)`` and
    per-task profiling are ported, and so is ``head_port=`` (the multi-host
    head service opens beside the dashboard) and now the thin client's
    ``util.connect``: a closed port refuses it with the socket's own error,
    a ``ClientServer`` beside the head serves it.  The name is historical:
    ``util.connect`` raised ``NotPortedError`` until the client was
    ported."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import util
    from ray_tpu_torch.util.client import ClientServer
    from torch_runtime_tasks import _crunch

    monkeypatch.setenv("RAY_TPU_USAGE_STATS_ENABLED", "1")
    with pytest.raises(ConnectionRefusedError):
        util.connect("127.0.0.1:1")
    rt.init(num_cpus=1, include_dashboard=True, head_port=0)
    try:
        assert rt.get_cluster().dashboard.url.startswith("http://127.0.0.1:")
        assert rt.get_cluster().head_service is not None
        server = ClientServer(port=0).start()
        try:
            with util.connect(server.address) as ctx:
                assert ctx.get(ctx.remote(_crunch).remote(10)) == 285
        finally:
            server.stop()
        f = rt.remote(_crunch).options(execution="process", runtime_env={"profiling": True,
                                                                         "env_vars": {"A": "1"}})
        assert rt.get(f.remote(10), timeout=120) == 285
    finally:
        rt.shutdown()


# --------------------------------------------------------------------------
# GPU work without a card: refused, never run on the CPU
# --------------------------------------------------------------------------
_HIDDEN = {"CUDA_VISIBLE_DEVICES": ""}


def test_gpu_job_without_a_card_fails_and_never_serves(tmp_path):
    """A submitted job whose driver asks for the card, where the card is
    hidden (its ``env_vars``; this host has none anyway), ends ``FAILED``
    with the engine's refusal; its driver never gets to serve."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.job_submission import JobSubmissionClient

    code = ("from ray_tpu_torch.models.transformer import TransformerConfig; "
            "from ray_tpu_torch.serve.llm import LLMEngine; "
            "LLMEngine(TransformerConfig(vocab_size=11, d_model=8, n_layers=1, n_heads=2), {}); "
            "print('served')")
    rt.init(num_cpus=1, include_dashboard=True)
    try:
        client = JobSubmissionClient(rt.get_cluster().dashboard.url)
        sid = client.submit_job(entrypoint=f"{sys.executable} -c \"{code}\"",
                                runtime_env={"env_vars": _HIDDEN})
        info = client.wait_until_finished(sid, timeout=120)
        logs = client.get_job_logs(sid)
    finally:
        rt.shutdown()
    assert info["status"] == "FAILED", logs
    assert "runs on CUDA by default and no CUDA device is available" in logs
    assert "served" not in logs.split("RuntimeError")[-1]


def test_gpu_workflow_step_without_a_card_fails_the_workflow(tmp_path, monkeypatch):
    """A workflow's GPU step (a GPU share, in process) whose engine finds
    no card raises: the workflow is ``FAILED`` and the step left no durable
    result to replay."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.serve.llm import LLMEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def gpu_step(prompt):
        eng = LLMEngine(TransformerConfig(vocab_size=11, d_model=8, n_layers=1, n_heads=2), {})
        return eng.generate(prompt, max_tokens=2)

    workflow.init(str(tmp_path / "wf"))
    rt.init(num_cpus=2, num_gpus=1)
    try:
        step = rt.remote(gpu_step).options(num_gpus=1, execution="thread")
        with pytest.raises(rt.RayTaskError, match="no CUDA device is available"):
            workflow.run(step.bind([1, 2]), workflow_id="wf_gpu")
        assert workflow.get_status("wf_gpu") == "FAILED"
        assert workflow.get_metadata("wf_gpu")["step_names"] == []
    finally:
        rt.shutdown()


def test_gpu_share_task_with_runtime_env_never_runs_on_the_cpu(tmp_path):
    """A ``num_gpus`` task with a ``runtime_env`` whose ``env_vars`` hide the
    card raises before its body runs (the same holds with no card at all:
    ``tests/test_torch_runtime_env.py``)."""
    import ray_tpu_torch as rt
    from torch_runtime_tasks import _gpu_body

    marker = str(tmp_path / "ran")
    rt.init(num_cpus=2, num_gpus=1)
    try:
        ref = rt.remote(_gpu_body).options(
            num_gpus=1, runtime_env={"env_vars": {**_HIDDEN, "MY_GPU_FLAG": "on"}}).remote(marker)
        with pytest.raises(rt.RayTaskError, match="hides the card"):
            rt.get(ref, timeout=120)
    finally:
        rt.shutdown()
    assert not os.path.exists(marker)


def test_scan_covers_the_operator_surface():
    """The import scan above reaches the CLI, the scripts, the autoscaler
    and the linter."""
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    for d in ("scripts", "autoscaler", "analysis"):
        assert any(r.startswith(os.path.join("ray_tpu_torch", d) + os.sep) for r in rel), d
    assert os.path.join("ray_tpu_torch", "__main__.py") in rel


def test_script_entry_points_refuse_to_run_without_cuda(monkeypatch):
    """``llm_bench`` and ``kernel_bench`` run on CUDA unless given the CPU:
    with no device named and no CUDA device they raise before any work."""
    from ray_tpu_torch.scripts import kernel_bench, llm_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: llm_bench.main(None), kernel_bench.bench_decode,
                 kernel_bench.bench_flash_blocks, lambda: kernel_bench.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("row", ["hbm_put_gigabytes", "hbm_get_gigabytes",
                                 "device_channel_edge_bw", "spmd_pipeline_iter",
                                 "train_step_scaling", "llm_paged_capacity_x"])
def test_microbench_device_rows_refuse_to_run_without_cuda(monkeypatch, row):
    import ray_tpu_torch as rt
    from ray_tpu_torch.scripts.microbench import run_suite

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rt.init(num_cpus=2)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_suite(rt, select=[row], quick=True)
        # refused before it started anything: no Serve thread outlives it
        assert not [t.name for t in threading.enumerate() if t.name.startswith("serve")]
    finally:
        rt.shutdown()


# --------------------------------------------------------------------------
# the multi-node core: node agents
# --------------------------------------------------------------------------
def test_agent_with_num_gpus_refuses_without_cuda():
    """An agent given ``--num-gpus`` where no CUDA device is visible exits
    non-zero with a message before it dials the head: it never registers a
    card it lacks.  Given none, it registers no GPU and loads no torch."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-m", "ray_tpu_torch.runtime.agent",
                        "--address", "127.0.0.1:1", "--num-gpus", "1"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2, p.stderr
    assert "--num-gpus 1 asks for more CUDA devices than this process sees (0)" in p.stderr
    code = ("import sys\n"
            "from ray_tpu_torch.runtime import agent\n"
            "rc = agent.main(['--address', '127.0.0.1:1', '--num-cpus', '1'])\n"
            "assert rc == 1, rc\n"  # nothing listens there: cannot join
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'ray_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def test_agent_without_num_gpus_registers_no_gpu_and_never_loads_torch():
    """An agent given no ``--num-gpus`` joins with no GPU, and after its
    report loop has sampled the host its process has loaded no torch (so it
    holds no CUDA context) and nothing of JAX."""
    import time

    import ray_tpu_torch as rt
    from torch_runtime_tasks import _worker_facts

    rt.init(num_cpus=1, num_gpus=0)
    agent = None
    try:
        cluster = rt.get_cluster()
        address = cluster.start_head_service()
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.path.join(REPO, "tests"))
        agent = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch.runtime.agent",
                                  "--address", address, "--num-cpus", "1",
                                  "--resources", '{"agent": 1}'],
                                 env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        deadline = time.monotonic() + 90
        while True:
            node = next((n for nid, n in cluster.nodes.items()
                         if nid != cluster.head_node.node_id and not n.dead), None)
            if node is not None and cluster.metrics_history.series(node.node_id.hex()):
                break  # its report loop has sampled the host
            assert agent.poll() is None and time.monotonic() < deadline, "the agent never reported"
            time.sleep(0.05)
        assert not node.pool.total.to_dict().get("GPU")
        facts = rt.get(rt.remote(_worker_facts).options(resources={"agent": 1},
                                                        execution="thread").remote(), timeout=60)
        assert facts["pid"] == agent.pid
        assert facts["torch_sees_cuda"] is None and facts["forbidden"] == []
    finally:
        if agent is not None:
            agent.kill()
            agent.wait(timeout=30)
        rt.shutdown()


def test_agent_host_names_never_match_the_jax_packages():
    """The agent's shm arena, its stale-segment reaper and its session
    directory are the port's own: neither package's reaper can unlink the
    other's live arena."""
    import re

    from ray_tpu.runtime import agent as jax_agent
    from ray_tpu_torch.runtime import agent as port_agent

    name = port_agent.agent_segment_name().lstrip("/")
    assert re.match(port_agent.AGENT_SEGMENT_RE, name)
    jax_pattern = r"rt_a([0-9a-f]+)_[0-9a-f]+$"  # ray_tpu/runtime/agent.py:1609
    jax_name = f"rt_a{os.getpid():x}_abcdef"
    assert re.match(jax_pattern, jax_name) and not re.match(jax_pattern, name)
    assert not re.match(port_agent.AGENT_SEGMENT_RE, jax_name)
    # the head's own arena (rttorch_<pid>_<id>) is not an agent's either
    assert not re.match(port_agent.AGENT_SEGMENT_RE, f"rttorch_{os.getpid()}_ab12")
    fabric = port_agent.NodeAgent.__new__(port_agent.NodeAgent)
    port_agent.NodeAgent.__init__(fabric, "127.0.0.1:1", {"CPU": 1})
    try:
        assert os.path.basename(fabric.session_dir) == f"ray_tpu_torch_agent_{os.getpid()}"
        assert fabric.session_dir != f"/tmp/ray_tpu_agent_{os.getpid()}"
    finally:
        os.rmdir(fabric.session_dir)
    assert "rt_a" in open(jax_agent.__file__).read()  # the reference's prefix


@pytest.mark.parametrize("head,agent", [("ray_tpu", "ray_tpu_torch"), ("ray_tpu_torch", "ray_tpu")])
def test_agent_of_the_other_package_is_refused_at_handshake(head, agent):
    """Each package's agent dialing the other package's head fails at
    ``register_node_config`` with ``ProtocolMismatchError`` (the process
    exits non-zero naming the mismatch) and is never registered."""
    import importlib

    rt = importlib.import_module(head)
    rt.init(num_cpus=1)
    try:
        cluster = rt.get_cluster()
        address = cluster.start_head_service()
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        p = subprocess.run([sys.executable, "-m", f"{agent}.runtime.agent", "--address", address,
                            "--num-cpus", "1"],
                           env=env, capture_output=True, text=True, timeout=120)
        assert p.returncode == 1, p.stderr[-2000:]
        assert "cannot join" in p.stderr and "protocol" in p.stderr and "mismatch" in p.stderr
        assert sum(1 for n in cluster.nodes.values() if not n.dead) == 1
    finally:
        rt.shutdown()


def test_protocol_check_raises_on_the_other_packages_reply():
    from ray_tpu.runtime import agent as jax_agent
    from ray_tpu.runtime import rpc as jax_rpc
    from ray_tpu_torch.runtime import agent as port_agent
    from ray_tpu_torch.runtime import rpc as port_rpc

    port_side = port_agent.NodeAgent.__new__(port_agent.NodeAgent)
    with pytest.raises(port_rpc.ProtocolMismatchError):
        port_side._check_protocol({"protocol_version": jax_rpc.PROTOCOL_VERSION})
    port_side._check_protocol({"protocol_version": port_rpc.PROTOCOL_VERSION,
                               "protocol": port_rpc.PROTOCOL_NAME})
    jax_side = jax_agent.NodeAgent.__new__(jax_agent.NodeAgent)
    with pytest.raises(jax_rpc.ProtocolMismatchError):
        jax_side._check_protocol({"protocol_version": port_rpc.PROTOCOL_VERSION,
                                  "protocol": port_rpc.PROTOCOL_NAME})


# --------------------------------------------------------------------------
# the agent-spawning providers and the thin client
# --------------------------------------------------------------------------
def _provider_commands(pkg, node_type, monkeypatch):
    """The agent command line each of ``pkg``'s agent-spawning providers
    would run for one node of ``node_type`` (nothing is started: the
    runners are recorded)."""
    import importlib
    import json
    import shlex
    import subprocess as sp

    np_mod = importlib.import_module(pkg + ".autoscaler.node_provider")
    kube = importlib.import_module(pkg + ".autoscaler.kuberay")
    gcp = importlib.import_module(pkg + ".autoscaler.gcp")
    demand = importlib.import_module(pkg + ".autoscaler.demand")
    nt = demand.NodeTypeConfig(*node_type)
    out = {}

    class _Popen:
        def __init__(self, argv, **kw):
            out["local"] = shlex.join(argv)

        def poll(self):
            return None

    monkeypatch.setattr(sp, "Popen", _Popen)
    np_mod.SubprocessNodeProvider("h:1").create_nodes(nt, 1)
    monkeypatch.setattr(sp, "run", lambda argv, **kw: out.setdefault("ssh", argv[-1]) and
                        sp.CompletedProcess(argv, 0, stdout="1\n", stderr=""))
    np_mod.SSHNodeProvider("h:1", ["w1"]).create_nodes(nt, 1)
    pods = []
    monkeypatch.setattr(kube.KubectlAPI, "_run",
                        lambda self, args, stdin=None: pods.append(stdin) if stdin else "")
    kube.KubernetesNodeProvider("h:1", api=kube.KubectlAPI()).create_nodes(nt, 1)
    out["kubectl"] = json.loads(pods[0])["spec"]["containers"][0]["command"][-1]
    out["gcloud"] = gcp.GcpTpuNodeProvider("h:1", zone="z", api=gcp.FakeGcloudTpuAPI(
        spawn=False)).agent_command("s-1", "v5e-8", 8)
    return out


def test_every_provider_command_names_the_ports_agent(monkeypatch):
    port = _provider_commands("ray_tpu_torch", ("w", {"CPU": 1}), monkeypatch)
    assert sorted(port) == ["gcloud", "kubectl", "local", "ssh"]
    for kind, cmd in port.items():
        assert "-m ray_tpu_torch.runtime.agent " in cmd, (kind, cmd)
    jax = _provider_commands("ray_tpu", ("w", {"CPU": 1}), monkeypatch)
    for kind, cmd in jax.items():
        assert "-m ray_tpu.runtime.agent " in cmd, (kind, cmd)


def test_gpu_node_type_becomes_num_gpus(monkeypatch):
    """A node type's ``"GPU"`` is the port agent's ``--num-gpus`` (the
    agent registers the card and refuses without it) on every provider;
    the JAX package passes it in ``--resources`` like any custom resource.
    ``"TPU"`` stays a resource in both."""
    import json
    import shlex

    def resources(cmd):
        argv = shlex.split(cmd.split(">>")[0])
        return json.loads(argv[argv.index("--resources") + 1]), argv

    node = ("g", {"CPU": 2, "GPU": 1, "TPU": 4})
    for kind, cmd in _provider_commands("ray_tpu_torch", node, monkeypatch).items():
        if kind == "gcloud":
            continue  # a slice's resources are its TPU chips
        res, argv = resources(cmd)
        assert "GPU" not in res and res.get("TPU") == 4, (kind, cmd)
        assert argv[argv.index("--num-gpus") + 1] == "1", (kind, cmd)
    for kind, cmd in _provider_commands("ray_tpu", node, monkeypatch).items():
        if kind == "gcloud":
            continue
        res, argv = resources(cmd)
        assert res.get("GPU") == 1 and "--num-gpus" not in argv, (kind, cmd)
    from ray_tpu_torch.autoscaler.node_provider import gpu_args, split_gpus

    assert split_gpus({"CPU": 1, "GPU": 0.5}) == ({"CPU": 1}, 0.5)
    assert gpu_args(0.5) == ["--num-gpus", "0.5"] and gpu_args(0) == []


@pytest.mark.parametrize("server_pkg,client_pkg", [("ray_tpu", "ray_tpu_torch"),
                                                   ("ray_tpu_torch", "ray_tpu")])
def test_client_and_server_of_different_packages_refuse_each_other(server_pkg, client_pkg):
    """A Python client of one package on the other's ``ClientServer``
    fails at ``connect`` with a typed error (the port's
    ``ClientProtocolError``, the JAX package's ``ConnectionRefusedError``),
    and a native client's magic of one package is refused by the other's
    server: the port answers the JAX magic with one error reply, the JAX
    server closes on the port's."""
    import importlib
    import socket
    import struct

    rt = importlib.import_module(server_pkg)
    rt.init(num_cpus=1)
    server = importlib.import_module(server_pkg + ".util.client.server").ClientServer(port=0)
    server.start()
    try:
        client = importlib.import_module(client_pkg + ".util.client")
        with pytest.raises(ConnectionRefusedError) as info:
            client.connect(server.address)
        if client_pkg == "ray_tpu_torch":
            assert isinstance(info.value, client.ClientProtocolError)
            assert "not a ray_tpu_torch client server" in str(info.value)
        else:
            assert "ray_tpu_torch client protocol" in str(info.value)
        magic = importlib.import_module(client_pkg + ".util.client.binary").BINARY_MAGIC
        with socket.create_connection((server.host, server.port), timeout=30) as s:
            s.sendall(magic + struct.pack("<IBQ", 0, 1, 7))  # then a PING
            got = b""
            while True:
                try:
                    chunk = s.recv(1 << 16)
                except ConnectionResetError:  # closed with our request unread
                    break
                if not chunk:
                    break
                got += chunk
        if server_pkg == "ray_tpu_torch":
            ln, status, _rid = struct.unpack("<IBQ", got[:13])
            assert status == 1 and b"RTTCBIN1" in got[13:13 + ln]
        else:
            assert got == b""  # closed without a reply
    finally:
        server.stop()
        rt.shutdown()


def test_new_modules_import_no_jax_nor_cloudpickle_at_top():
    """The client and the launcher modules import nothing of JAX or of the
    JAX package, and no ``cloudpickle`` at module level (the card's machine
    may not have it: frames go through ``core/serialization``)."""
    files = [os.path.join(REPO, "ray_tpu_torch", *p) for p in (
        ("util", "client", "__init__.py"), ("util", "client", "common.py"),
        ("util", "client", "binary.py"), ("util", "client", "server.py"),
        ("util", "client", "worker.py"), ("util", "client", "proxier.py"),
        ("autoscaler", "launcher.py"), ("autoscaler", "node_provider.py"),
        ("runtime", "channel_manager.py"), ("dag", "plan.py"))]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in tree.body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module
                     else [])
            assert not any(n.split(".")[0] == "cloudpickle" for n in names), path
        assert not [m for m in _imported_modules(path)
                    if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu")], path


# --------------------------------------------------------------------------
# rllib
# --------------------------------------------------------------------------
_RLLIB_MODULES = (
    "ray_tpu_torch.rllib", "ray_tpu_torch.rllib.sample_batch", "ray_tpu_torch.rllib.envs",
    "ray_tpu_torch.rllib.rl_module", "ray_tpu_torch.rllib.connectors",
    "ray_tpu_torch.rllib.replay_buffer", "ray_tpu_torch.rllib.learner",
    "ray_tpu_torch.rllib.env_runner", "ray_tpu_torch.rllib.offline",
    "ray_tpu_torch.rllib.external_env", "ray_tpu_torch.rllib.algorithm",
    "ray_tpu_torch.rllib.algorithms", "ray_tpu_torch.rllib.algorithms.ppo",
    "ray_tpu_torch.rllib.algorithms.impala", "ray_tpu_torch.rllib.algorithms.dqn",
    "ray_tpu_torch.rllib.algorithms.sac", "ray_tpu_torch.rllib.algorithms.bc",
    "ray_tpu_torch.rllib.algorithms.marwil", "ray_tpu_torch.rllib.algorithms.cql",
    "ray_tpu_torch.rllib.algorithms.registry",
    # part 2
    "ray_tpu_torch.rllib.algorithms.pg", "ray_tpu_torch.rllib.algorithms.simple_q",
    "ray_tpu_torch.rllib.algorithms.ddpg", "ray_tpu_torch.rllib.algorithms.es",
    "ray_tpu_torch.rllib.algorithms.bandit", "ray_tpu_torch.rllib.algorithms.crr",
    "ray_tpu_torch.rllib.algorithms.r2d2", "ray_tpu_torch.rllib.algorithms.maddpg",
    "ray_tpu_torch.rllib.algorithms.qmix", "ray_tpu_torch.rllib.algorithms.dt",
    "ray_tpu_torch.rllib.algorithms.dreamerv3",
)


def test_importing_rllib_loads_no_jax_optax_or_the_jax_package():
    """The 30 modules of ``rllib`` (and its package) import neither JAX nor
    optax (which imports JAX) nor anything of the JAX package; the AST scan
    above covers their files too."""
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    assert sum(r.startswith(os.path.join("ray_tpu_torch", "rllib") + os.sep) for r in rel) == 31
    code = (
        f"import importlib, sys\nfor m in {_RLLIB_MODULES!r}: importlib.import_module(m)\n"
        "import ray_tpu_torch as rt\nassert rt.rllib.PPOConfig is not None\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'ray_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def _rllib_entry_points(device):
    """Each entry point of ``rllib`` that takes a device, called with
    ``device`` (None: the default)."""
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib import offline
    from ray_tpu_torch.rllib.algorithm import Algorithm
    from ray_tpu_torch.rllib.algorithms.ppo import _ppo_loss

    env, penv = rllib.CartPole(), rllib.Pendulum()
    m = rllib.ActorCriticModule(4, 2, (4,))
    data = rllib.SampleBatch({
        "obs": np.zeros((8, 3), np.float32), "next_obs": np.zeros((8, 3), np.float32),
        "actions": np.zeros((8, 1), np.float32), "rewards": np.zeros(8, np.float32),
        "dones": np.zeros(8, bool), "returns": np.zeros(8, np.float32)})
    calls = {
        "EnvRunner": lambda: rllib.EnvRunner(env, m, device=device),
        "EnvRunnerGroup": lambda: rllib.EnvRunnerGroup(env, m, device=device),
        "Learner": lambda: rllib.Learner(m, _ppo_loss(m, 0.2, 0.0, 0.5), device=device),
        "GymEnvRunner": lambda: rllib.GymEnvRunner([], m, num_actions=2, device=device),
        "MultiAgentEnvRunner": lambda: rllib.MultiAgentEnvRunner(rllib.MultiAgentEnv(), m,
                                                                 device=device),
        "record_rollouts": lambda: offline.record_rollouts(env, m, m.init(
            torch.Generator().manual_seed(0)), num_iterations=1, num_envs=2, rollout_length=2,
            device=device),
    }
    for name in ("PPO", "IMPALA", "APPO", "DQN", "SAC", "BC", "MARWIL", "CQL"):
        cfg = getattr(rllib, name + "Config")().environment(
            penv if name in ("SAC", "CQL") else env).resources(device=device)
        if name in ("BC", "MARWIL", "CQL"):
            cfg.offline(data)
        calls[name] = cfg.build
    # part 2: every algorithm of the registry, and the envs' reset
    seq = rllib.SampleBatch({"obs": np.zeros((8, 2, 4), np.float32),
                             "actions": np.zeros((8, 2), np.int32),
                             "rewards": np.ones((8, 2), np.float32),
                             "dones": np.zeros((8, 2), bool)})
    part2 = {"PG": env, "A2C": env, "A3C": env, "SimpleQ": env, "APEX": env, "DDPG": penv,
             "TD3": penv, "ES": env, "ARS": env, "R2D2": env, "CRR": penv, "DT": env,
             "DreamerV3": env, "BanditLinUCB": rllib.LinearBanditEnv(),
             "BanditLinTS": rllib.LinearBanditEnv(),
             "MADDPG": rllib.SimpleSpread(n_agents=2), "QMIX": rllib.DiscreteSpread(n_agents=2)}
    for name, e in part2.items():
        cfg = rllib.get_algorithm_config(name).environment(e).resources(device=device)
        if name == "CRR":
            cfg.offline_data(data)
        if name == "DT":
            cfg.offline_data(seq)
        calls[name] = cfg.build
    return calls, Algorithm


def test_rllib_entry_points_refuse_to_run_without_cuda(monkeypatch, tmp_path):
    """With no CUDA device and none named, every rllib entry point raises
    before any work (no ``try`` falls back to the CPU); given ``"cpu"``
    each runs there, and a checkpoint saved so revives on the CPU only when
    asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls, Algorithm = _rllib_entry_points(None)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    calls, _ = _rllib_entry_points("cpu")
    built = {name: call() for name, call in calls.items()}
    assert built["PPO"].device.type == "cpu" and built["Learner"].device.type == "cpu"
    assert all(a.device.type == "cpu" for a in built.values() if hasattr(a, "train"))
    algo = built["PPO"]
    algo.config.device = None  # as a config saved on the card holds it
    path = algo.save(str(tmp_path / "ppo.pkl"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Algorithm.from_checkpoint(path)
    assert Algorithm.from_checkpoint(path, device="cpu").device.type == "cpu"


def test_rllib_names_resolve_and_the_registry_is_the_jax_packages():
    """``__all__`` equals the JAX package's (``rllib`` and
    ``rllib.algorithms``) and every name of both resolves (none raises
    ``NotPortedError`` since part 2, ROADMAP item 12); the registry lists the
    JAX package's names, each with the port's class of the same name and its
    config, case-insensitively."""
    import ray_tpu.rllib as jrl
    import ray_tpu.rllib.algorithms as jalgos
    import ray_tpu_torch.rllib as trl
    import ray_tpu_torch.rllib.algorithms as talgos
    from ray_tpu_torch.rllib.algorithms import registry

    assert trl.__all__ == jrl.__all__ and talgos.__all__ == jalgos.__all__
    for mod, names in ((trl, jrl.__all__), (talgos, jalgos.__all__)):
        for name in names:
            assert getattr(mod, name) is not None, name
    assert not hasattr(registry, "NOT_PORTED") and not hasattr(registry, "NOT_PORTED_NAMES")
    assert trl.list_algorithms() == jrl.list_algorithms() and len(trl.list_algorithms()) == 25
    for name in jrl.list_algorithms():
        jcls, tcls = jrl.get_algorithm_class(name), trl.get_algorithm_class(name.lower())
        assert tcls.__name__ == jcls.__name__, name
        assert tcls.__module__ == jcls.__module__.replace("ray_tpu.", "ray_tpu_torch.", 1)
        cfg = trl.get_algorithm_config(name)
        assert cfg.algo_class is tcls and type(cfg).__name__ == type(
            jrl.get_algorithm_config(name)).__name__
        assert set(vars(cfg)) - {"device"} == set(vars(jrl.get_algorithm_config(name))), name
    with pytest.raises(ValueError, match="unknown algorithm"):
        trl.get_algorithm_class("nope")


def test_bandit_env_draws_its_problem_from_each_packages_generator():
    """D5 (ROADMAP Queue 3): the JAX package's ``LinearBanditEnv`` draws its
    arm weights from ``jax.random.key(env_seed)`` and its step draws from the
    per-env JAX key in its state; the port's draws the weights from a
    ``torch.Generator`` seeded with ``env_seed`` and its step draws from a
    per-env integer key in its state (MINSTD), drawn at reset from the
    caller's generator. The same seed is another draw of the same problem;
    a state steps to the same draws wherever it is stepped."""
    import jax

    import ray_tpu.rllib as jrl
    import ray_tpu_torch.rllib as trl

    jenv = jrl.LinearBanditEnv(num_arms=4, context_dim=6, env_seed=3)
    tenv = trl.LinearBanditEnv(num_arms=4, context_dim=6, env_seed=3)
    jw = np.asarray(jenv._weights())
    np.testing.assert_array_equal(jw, np.asarray(jax.random.normal(jax.random.key(3), (4, 6))))
    tw = tenv._weights("cpu")
    assert torch.equal(tw, torch.randn((4, 6), generator=torch.Generator().manual_seed(3)))
    assert not np.allclose(tw.numpy(), jw)
    jstate, _ = jenv.reset(jax.random.key(0))
    assert jax.dtypes.issubdtype(jstate["key"].dtype, jax.dtypes.prng_key)
    state, ctx = tenv.reset(torch.Generator().manual_seed(0), 4096, "cpu")
    assert state["key"].dtype == torch.int64 and len(set(state["key"].tolist())) > 4000
    arms = torch.randint(0, 4, (4096,), generator=torch.Generator().manual_seed(1))
    a, b = tenv.step(state, arms), tenv.step(state, arms)
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    assert not torch.equal(a[0]["key"], state["key"])
    # the step's draws are standard normals: the noise and the next contexts
    noise = (a[2] - torch.sum(tw[arms] * ctx, -1)) / tenv.noise
    for z in (noise, a[1].reshape(-1)):
        assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1.0) < 0.05


class _RecordedActorClass:
    """Stands for ``remote(cls)``: records the options and the constructor's
    ``device`` of each actor made."""

    made = []

    def __init__(self, cls, opts=None):
        self.cls, self.opts = cls, dict(opts or {})

    def options(self, **kw):
        return _RecordedActorClass(self.cls, {**self.opts, **kw})

    def remote(self, *args, **kw):
        _RecordedActorClass.made.append((self.cls.__name__, self.opts, kw.get("device")))
        return object()


def test_remote_env_runners_take_a_gpu_share_only_on_the_card(monkeypatch):
    """D3 (ROADMAP Queue 3): a remote runner of the port on CUDA holds
    ``1/num_runners`` of a GPU (an in-process GPU actor beside the card);
    given the CPU it is a plain actor, as every JAX package runner is."""
    import ray_tpu
    import ray_tpu.rllib as jrl
    import ray_tpu_torch
    import ray_tpu_torch.rllib as trl

    monkeypatch.setattr(ray_tpu_torch, "remote", _RecordedActorClass)
    monkeypatch.setattr(ray_tpu, "remote", _RecordedActorClass)
    made = _RecordedActorClass.made
    made.clear()
    m = trl.ActorCriticModule(4, 2, (4,))
    trl.EnvRunnerGroup(trl.CartPole(), m, num_runners=2, remote=True, device="cuda")
    assert made == [("EnvRunner", {"num_gpus": 0.5}, "cuda")] * 2
    made.clear()
    trl.EnvRunnerGroup(trl.CartPole(), m, num_runners=4, remote=True, device="cpu")
    assert made == [("EnvRunner", {}, "cpu")] * 4
    made.clear()
    jm = jrl.rl_module.ActorCriticModule(4, 2, (4,))
    jrl.EnvRunnerGroup(jrl.CartPole(), jm, num_runners=2, remote=True)
    assert made == [("EnvRunner", {}, None)] * 2
