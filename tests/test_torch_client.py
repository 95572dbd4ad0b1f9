"""The port's thin client (``ray_tpu_torch.util.client``, ``util.connect``)
and its native C++ client against the JAX package's.

Every case of ``test_client.py`` (11) and of ``test_cpp_client.py`` (2),
and the proxy case of ``test_runtime_env_plugins.py``, run here through
both packages: the JAX test's own body once as written
against a JAX ``ClientServer``, and once ported (``tests/torch_ported.py``:
globals and imports bound to ``ray_tpu_torch``) against the port's server.
The C++ case of the port builds ``tests/torch_cpp_client_main.cpp`` (the
JAX test's checks over the port's client, namespace ``ray_tpu_torch``)
against the port's client library with ``native/_build.py``; both C++ cases
skip without ``g++``, as the JAX test does.  A tensor on the server reaches
a port client as a CPU tensor of the same dtype, shape and values.
"""

import importlib
import inspect
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from torch_ported import ported

torch = pytest.importorskip("torch")

import test_client as jax_client  # noqa: E402
import test_cpp_client as jax_cpp  # noqa: E402
import test_runtime_env_plugins as jax_rep  # noqa: E402

PACKAGES = ("ray_tpu", "ray_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIENT_CASES = sorted(n for n in vars(jax_client) if n.startswith("test_"))


def test_the_cases_are_the_jax_files():
    assert len(CLIENT_CASES) == 11
    assert sorted(n for n in vars(jax_cpp) if n.startswith("test_")) == [
        "test_binary_protocol_python_roundtrip", "test_cpp_client_end_to_end"]


class _Server:
    """A runtime of ``pkg`` and its ``ClientServer`` on a free port."""

    def __init__(self, pkg: str):
        self.rt = importlib.import_module(pkg)
        if self.rt.is_initialized():
            self.rt.shutdown()
        self.rt.init(num_cpus=4)
        server_mod = importlib.import_module(pkg + ".util.client.server")
        self.server = server_mod.ClientServer(port=0).start()

    def close(self):
        self.server.stop()
        self.rt.shutdown()


@pytest.fixture
def server_of():
    made = []

    def make(pkg):
        made.append(_Server(pkg))
        return made[-1].server

    yield make
    for s in made:
        s.close()


def _body(module, name, pkg):
    fn = getattr(module, name)
    return fn if pkg == "ray_tpu" else ported(fn)


@pytest.mark.parametrize("case", CLIENT_CASES)
@pytest.mark.parametrize("pkg", PACKAGES)
def test_client_case(case, pkg, server_of):
    fn = _body(jax_client, case, pkg)
    assert list(inspect.signature(fn).parameters) == ["client_server"]
    fn(client_server=server_of(pkg))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cpp_binary_protocol_python_roundtrip(pkg, server_of):
    _body(jax_cpp, "test_binary_protocol_python_roundtrip", pkg)(client_server=server_of(pkg))


def _cpp_binary(pkg, tmp_path) -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    if pkg == "ray_tpu":
        out = str(tmp_path / "cpp_client_test")
        subprocess.run([gxx, "-O1", "-std=c++17", os.path.join(REPO, "tests", "cpp_client_main.cpp"),
                        os.path.join(REPO, "ray_tpu", "native", "src", "client.cpp"), "-o", out],
                       check=True, capture_output=True)
        return out
    from ray_tpu_torch.native import _build

    return _build.program(os.path.join(REPO, "tests", "torch_cpp_client_main.cpp"),
                          "torch_cpp_client_main")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cpp_client_end_to_end(pkg, server_of, tmp_path):
    binary = _cpp_binary(pkg, tmp_path)
    server = server_of(pkg)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([REPO] + sys.path)}
    proc = subprocess.run([binary, server.host, str(server.port)], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, f"stdout={proc.stdout!r} stderr={proc.stderr!r}"
    assert "CPP CLIENT OK" in proc.stdout


def test_tensor_refs_reach_the_client_as_cpu_tensors(server_of):
    """What a thin client receives for a ref that holds a tensor: the CPU
    case here (a CUDA tensor takes the same path, ``tests/test_torch_cuda.py``
    ``-k multinode``): same dtype, shape and values, on the CPU."""
    from ray_tpu_torch.util import connect

    server = server_of("ray_tpu_torch")
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)).to(torch.bfloat16)
    with connect(server.address) as ctx:
        back = ctx.get(ctx.put(x))
        made = ctx.get(ctx.remote(torch.ones).remote(3, 4))
    assert isinstance(back, torch.Tensor) and back.device.type == "cpu"
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)
    assert isinstance(made, torch.Tensor) and torch.equal(made, torch.ones(3, 4))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_client_proxy_isolates_tenants(pkg):
    """Two clients through one ``ProxyServer`` get separate backend driver
    processes, their bytes spliced through the proxy."""
    _body(jax_rep, "test_client_proxy_isolates_tenants", pkg)()


def test_proxy_hands_each_tenant_a_port_server():
    """Each tenant of the port's proxy gets its own process running the
    port's ``ClientServer`` with the port's runtime (the handshake would
    refuse a JAX backend): the tasks of the two tenants run under two
    backend drivers, and each backend goes when its session ends."""
    import time

    from ray_tpu_torch.util.client.proxier import ProxyServer
    from ray_tpu_torch.util.client.worker import connect

    def where():
        import os
        import sys

        return ({os.getpid(), os.getppid()}, "ray_tpu_torch.api" in sys.modules,
                "ray_tpu.api" in sys.modules)

    proxy = ProxyServer(port=0, num_cpus_per_backend=1, warm_backends=1).start()
    try:
        ctxs = [connect(proxy.address), connect(proxy.address)]
        try:
            seen = [ctx.get(ctx.remote(where).remote(), timeout=120) for ctx in ctxs]
            backends = list(proxy._active)
            assert len(backends) == 2
            for b in backends:
                assert b.proc.args[1:3] == ["-m", "ray_tpu_torch.util.client.server"]
            # each tenant's task ran in (or under) its own backend driver
            owners = [s[0] & {b.proc.pid for b in backends} for s in seen]
            assert all(len(o) == 1 for o in owners) and owners[0] != owners[1]
            assert [s[1:] for s in seen] == [(True, False), (True, False)]
        finally:
            for ctx in ctxs:
                ctx.disconnect()
        deadline = time.monotonic() + 30
        while proxy._active and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not proxy._active
        assert all(b.proc.poll() is not None for b in backends)
    finally:
        proxy.stop()
