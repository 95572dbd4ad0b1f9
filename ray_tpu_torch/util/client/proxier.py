"""Client-server proxy mode: one endpoint multiplexing isolated drivers.

Parity with the reference's proxier
(``python/ray/util/client/server/proxier.py``): a single public ``ray://``
endpoint accepts many clients and gives each its own *dedicated backend
driver process* (a ``ray_tpu_torch.util.client.server`` instance with its
own runtime), so tenants cannot see each other's objects, actors, or crashes —
the reference's ``SpecificServer``-per-client design.

The proxy itself never parses client traffic: after pairing a connection
with a backend it splices bytes in both directions (works for both the
Python pickle-frame protocol and the C++ binary protocol, which the backend
sniffs itself).  A small warm pool hides the backend's runtime-start
latency; exited backends are reaped and respawned on demand.

The port's copy of ``ray_tpu/util/client/proxier.py``: its backends are
the port's servers, started with this package's root first on their
``PYTHONPATH``, so a proxy of one package never hands a tenant the other's
runtime.

Run standalone::

    python -m ray_tpu_torch.util.client.proxier --port 10001 --num-cpus 4
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional


class _Backend:
    """One dedicated driver process serving exactly one client at a time."""

    def __init__(self, num_cpus: Optional[int], extra_args: Optional[List[str]] = None):
        # backend picks its own free port and prints it; --port 0 delegates
        # the choice to the OS
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            self.port = probe.getsockname()[1]
        cmd = [
            sys.executable, "-m", "ray_tpu_torch.util.client.server",
            "--host", "127.0.0.1", "--port", str(self.port),
        ]
        if num_cpus is not None:
            cmd += ["--num-cpus", str(num_cpus)]
        cmd += extra_args or []
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env
        )
        self._ready = threading.Event()
        threading.Thread(target=self._watch_ready, name="proxy-backend-ready", daemon=True).start()

    def _watch_ready(self) -> None:
        for line in self.proc.stdout:  # server prints its listen line once up
            if "listening on" in line:
                self._ready.set()
        # keep draining so the pipe never fills
        self._ready.set()

    def wait_ready(self, timeout: float = 120.0) -> bool:
        ok = self._ready.wait(timeout)
        return ok and self.proc.poll() is None

    def connect(self) -> socket.socket:
        return socket.create_connection(("127.0.0.1", self.port), timeout=10)

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()


class ProxyServer:
    """Accepts clients, pairs each with a dedicated backend, splices bytes."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 10001,
        num_cpus_per_backend: Optional[int] = None,
        warm_backends: int = 1,
    ):
        self._num_cpus = num_cpus_per_backend
        self._sock = socket.create_server((host, port))
        self.host, self.port = self._sock.getsockname()[:2]
        self.address = f"{self.host}:{self.port}"
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._warm: List[_Backend] = []
        self._active: List[_Backend] = []
        self._warm_target = max(0, warm_backends)
        for _ in range(self._warm_target):
            self._warm.append(_Backend(self._num_cpus))
        self._thread = threading.Thread(target=self._accept_loop, name="rt-proxy", daemon=True)

    def start(self) -> "ProxyServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            backends = self._warm + self._active
            self._warm, self._active = [], []
        for b in backends:
            b.kill()

    # ------------------------------------------------------------------
    def _take_backend(self) -> _Backend:
        with self._lock:
            while self._warm:
                b = self._warm.pop()
                if b.alive:
                    break
                b.kill()
            else:
                b = _Backend(self._num_cpus)
            self._active.append(b)
        # refill the warm pool off-thread so the next client doesn't pay
        # the runtime-start latency either
        def refill():
            with self._lock:
                deficit = self._warm_target - len(self._warm)
            for _ in range(max(0, deficit)):
                nb = _Backend(self._num_cpus)
                with self._lock:
                    if self._stop.is_set():
                        nb.kill()
                        return
                    self._warm.append(nb)

        threading.Thread(target=refill, name="proxy-refill", daemon=True).start()
        return b

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
                name=f"proxy-conn-{addr[1]}",
            ).start()

    def _serve_conn(self, client: socket.socket) -> None:
        backend = self._take_backend()
        try:
            if not backend.wait_ready():
                client.close()
                return
            upstream = backend.connect()
        except OSError:
            client.close()
            return

        def pump(src: socket.socket, dst: socket.socket) -> None:
            try:
                while True:
                    data = src.recv(1 << 16)
                    if not data:
                        break
                    dst.sendall(data)
            except OSError:
                pass
            finally:
                for s in (src, dst):
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

        t1 = threading.Thread(target=pump, args=(client, upstream), daemon=True)
        t2 = threading.Thread(target=pump, args=(upstream, client), daemon=True)
        t1.start()
        t2.start()
        t1.join()
        t2.join()
        for s in (client, upstream):
            try:
                s.close()
            except OSError:
                pass
        # session over: the tenant's driver dies with it (full isolation —
        # reference proxier reaps SpecificServers on disconnect the same way)
        backend.kill()
        with self._lock:
            try:
                self._active.remove(backend)
            except ValueError:
                pass


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="ray_tpu_torch client proxy (multi-tenant)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=10001)
    parser.add_argument("--num-cpus", type=int, default=None, help="CPUs per tenant backend")
    parser.add_argument("--warm", type=int, default=1, help="prestarted warm backends")
    args = parser.parse_args(argv)

    proxy = ProxyServer(args.host, args.port, args.num_cpus, warm_backends=args.warm).start()
    print(f"ray_tpu_torch client proxy listening on {proxy.address}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        proxy.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
