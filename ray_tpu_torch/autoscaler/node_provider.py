"""Node providers: how the autoscaler materializes/terminates nodes.

Rebuild of the reference provider plugin layer
(``python/ray/autoscaler/node_provider.py``; cloud impls under
``_private/{aws,gcp,...}``; fake in-process impl
``_private/fake_multi_node/node_provider.py:237``). Here the primary
provider creates real in-process nodes on the live ``Cluster`` fabric — the
reference's fake-multinode testing strategy promoted to the main path — and
the TPU provider adds slice-awareness: a worker is a whole TPU slice
(v5e-8 etc.), created and removed atomically so device meshes never straddle
a partial slice (``python/ray/_private/accelerators/tpu.py:13-33`` pod-type
resources are the reference's version of this).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.autoscaler.demand import NodeTypeConfig

#: the node agent every provider starts: the port's, never the JAX package's
AGENT_MODULE = "ray_tpu_torch.runtime.agent"


def split_gpus(resources: Dict[str, float]) -> Tuple[Dict[str, float], float]:
    """A node type's resources as the port's agent takes them: ``"GPU"``
    becomes ``--num-gpus`` (the agent registers the card itself and refuses
    to start where it sees fewer CUDA devices), the rest stays for
    ``--resources``.  The JAX package passes ``"GPU"`` in ``--resources``
    like any custom resource; ``"TPU"`` keeps its meaning in both."""
    rest = dict(resources)
    return rest, float(rest.pop("GPU", 0) or 0)


def gpu_args(gpus: float) -> List[str]:
    """The agent's ``--num-gpus`` arguments for ``gpus`` (none for 0)."""
    return ["--num-gpus", f"{gpus:g}"] if gpus else []


# TPU slice catalog: pod type -> (hosts, chips per host).  Mirrors the
# topologies the reference's TPU accelerator module detects from
# TPU_ACCELERATOR_TYPE / GCE metadata (accelerators/tpu.py).
TPU_SLICE_TOPOLOGIES: Dict[str, Dict[str, int]] = {
    "v4-8": {"hosts": 1, "chips_per_host": 4},
    "v4-16": {"hosts": 2, "chips_per_host": 4},
    "v5e-4": {"hosts": 1, "chips_per_host": 4},
    "v5e-8": {"hosts": 1, "chips_per_host": 8},
    "v5e-16": {"hosts": 2, "chips_per_host": 8},
    "v5e-32": {"hosts": 4, "chips_per_host": 8},
    "v5p-8": {"hosts": 1, "chips_per_host": 4},
    "v6e-8": {"hosts": 1, "chips_per_host": 8},
}


class NodeProvider:
    """Abstract provider (reference ``NodeProvider``): create/terminate
    nodes of a named type and enumerate what is running."""

    def create_nodes(self, node_type: NodeTypeConfig, count: int) -> List[str]:
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> Dict[str, str]:
        """provider_node_id -> node type name."""
        raise NotImplementedError


class InProcessNodeProvider(NodeProvider):
    """Materializes autoscaled nodes as real in-process ``Node``s on the
    cluster fabric — every scheduler/object-store/failure path is exercised
    for real, per the reference's fake-multinode design."""

    def __init__(self, cluster):
        self._cluster = cluster
        self._lock = threading.Lock()
        self._managed: Dict[str, str] = {}  # node_id hex -> type name

    def create_nodes(self, node_type: NodeTypeConfig, count: int) -> List[str]:
        created = []
        for _ in range(count):
            labels = dict(node_type.labels)
            labels.setdefault("ray_tpu.io/node-type", node_type.name)
            node = self._cluster.add_node(dict(node_type.resources), labels=labels)
            with self._lock:
                self._managed[node.node_id.hex()] = node_type.name
            created.append(node.node_id.hex())
        return created

    def terminate_node(self, provider_node_id: str) -> None:
        with self._lock:
            self._managed.pop(provider_node_id, None)
        for node_id, node in list(self._cluster.nodes.items()):
            if node_id.hex() == provider_node_id and not node.dead:
                # graceful removal (reference DrainRaylet,
                # node_manager.proto:391): stop placements, evacuate
                # sole-replica objects, restart actors elsewhere, THEN
                # terminate — idle scale-down must never strand the only
                # copy of an object someone still holds a ref to
                self._cluster.drain_node(node_id)
                return

    def non_terminated_nodes(self) -> Dict[str, str]:
        with self._lock:
            managed = dict(self._managed)
        alive = {nid.hex() for nid, n in list(self._cluster.nodes.items()) if not n.dead}
        return {pid: t for pid, t in managed.items() if pid in alive}


class TPUSliceProvider(InProcessNodeProvider):
    """Slice-atomic TPU provider: one ``create_nodes`` call for a slice type
    adds all its hosts (each host node carries its chip count as the "TPU"
    resource plus slice labels); termination removes every host of the slice
    so no partial mesh survives."""

    def __init__(self, cluster):
        super().__init__(cluster)
        self._slices: Dict[str, List[str]] = {}  # slice id -> member node ids
        self._slice_seq = 0

    @staticmethod
    def node_type_for(pod_type: str, **kw) -> NodeTypeConfig:
        """Advertised capacity is the PER-HOST shape (what a created node
        really exposes) plus the slice head token. Gang demands for a whole
        multi-host slice target the ``TPU-<pod>-head`` resource (reference
        tpu.py:28), not an aggregate chip count no single host can satisfy."""
        topo = TPU_SLICE_TOPOLOGIES[pod_type]
        return NodeTypeConfig(
            name=pod_type,
            resources={
                "CPU": 8.0,
                "TPU": float(topo["chips_per_host"]),
                f"TPU-{pod_type}-head": 1.0,
            },
            labels={"ray_tpu.io/pod-type": pod_type},
            **kw,
        )

    def create_nodes(self, node_type: NodeTypeConfig, count: int) -> List[str]:
        topo = TPU_SLICE_TOPOLOGIES.get(node_type.name)
        if topo is None:
            return super().create_nodes(node_type, count)
        created = []
        for _ in range(count):
            with self._lock:
                self._slice_seq += 1
                slice_id = f"{node_type.name}-{self._slice_seq}"
            members = []
            for host in range(topo["hosts"]):
                labels = dict(node_type.labels)
                labels.update(
                    {
                        "ray_tpu.io/pod-type": node_type.name,
                        "ray_tpu.io/slice-id": slice_id,
                        "ray_tpu.io/worker-index": str(host),
                        "ray_tpu.io/node-type": node_type.name,
                    }
                )
                resources = {"CPU": 8.0, "TPU": float(topo["chips_per_host"])}
                # head host of the slice carries the gang-scheduling token
                # (reference: the "TPU-<pod_type>-head" resource, tpu.py:28)
                if host == 0:
                    resources[f"TPU-{node_type.name}-head"] = 1.0
                node = self._cluster.add_node(resources, labels=labels)
                with self._lock:
                    self._managed[node.node_id.hex()] = node_type.name
                members.append(node.node_id.hex())
            with self._lock:
                self._slices[slice_id] = members
            created.append(slice_id)
        return created

    def terminate_node(self, provider_node_id: str) -> None:
        with self._lock:
            members = self._slices.pop(provider_node_id, None)
        if members is None:
            super().terminate_node(provider_node_id)
            return
        for member in members:
            super().terminate_node(member)

    def non_terminated_nodes(self) -> Dict[str, str]:
        alive_members = super().non_terminated_nodes()
        out: Dict[str, str] = dict(alive_members)
        with self._lock:
            slices = {s: list(m) for s, m in self._slices.items()}
        for slice_id, members in slices.items():
            if any(m in alive_members for m in members):
                out[slice_id] = slice_id.rsplit("-", 1)[0]
                for m in members:
                    out.pop(m, None)
        return out

    def slice_members(self, slice_id: str) -> List[str]:
        with self._lock:
            return list(self._slices.get(slice_id, []))


class SubprocessNodeProvider(NodeProvider):
    """Materializes nodes as REAL node-agent OS processes joining the head
    over the transport (``python -m ray_tpu_torch.runtime.agent``).

    This is the provisioning path `rt up` uses for provider type "local":
    elastic scale-up spawns a process, scale-down/terminate kills it and the
    head's disconnect handling runs the node-failure path. Role parity with
    the reference's local node provider + command runner
    (``python/ray/autoscaler/_private/local/node_provider.py``,
    ``command_runner.py``) with exec replacing SSH on one machine.  A node
    type's ``"GPU"`` is the agent's ``--num-gpus`` (:func:`split_gpus`), and
    the agent's ``PYTHONPATH`` starts with this package's root."""

    def __init__(self, head_address: str, python: Optional[str] = None):
        import sys as _sys

        self.head_address = head_address
        self._python = python or _sys.executable
        self._lock = threading.Lock()
        self._procs: Dict[str, object] = {}       # provider id -> Popen
        self._types: Dict[str, str] = {}

    def command(self, node_type: NodeTypeConfig, provider_id: str) -> List[str]:
        """The agent's command line for one node of ``node_type``."""
        import json as _json

        resources = dict(node_type.resources)
        cpus = resources.pop("CPU", 1)
        resources, gpus = split_gpus(resources)
        # the provider id rides as a node label so the autoscaler can
        # match its managed ids to live cluster nodes (busy/idle view)
        labels = {**node_type.labels, "rt_provider_id": provider_id}
        return [
            self._python, "-m", AGENT_MODULE,
            "--address", self.head_address,
            "--num-cpus", str(cpus),
            *gpu_args(gpus),
            "--resources", _json.dumps(resources),
            "--labels", _json.dumps(labels),
        ]

    def create_nodes(self, node_type: NodeTypeConfig, count: int) -> List[str]:
        import os as _os
        import subprocess as _sp
        import uuid as _uuid

        root = _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
        created = []
        for _ in range(count):
            env = dict(_os.environ)
            env["PYTHONPATH"] = root + _os.pathsep + env.get("PYTHONPATH", "")
            pid = f"proc-{_uuid.uuid4().hex[:12]}"
            proc = _sp.Popen(
                self.command(node_type, pid),
                env=env,
                stdout=_sp.DEVNULL,
                stderr=_sp.DEVNULL,
            )
            with self._lock:
                self._procs[pid] = proc
                self._types[pid] = node_type.name
            created.append(pid)
        return created

    def terminate_node(self, provider_node_id: str) -> None:
        with self._lock:
            proc = self._procs.pop(provider_node_id, None)
            self._types.pop(provider_node_id, None)
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except Exception:  # noqa: BLE001
                proc.kill()

    def non_terminated_nodes(self) -> Dict[str, str]:
        with self._lock:
            return {
                pid: t for pid, t in self._types.items()
                if self._procs[pid].poll() is None
            }


class SSHNodeProvider(NodeProvider):
    """Starts node agents on remote machines over SSH (``ray up`` role:
    ``python/ray/autoscaler/_private/command_runner.py`` SSHCommandRunner).

    Config: a list of hosts, an ssh user/key, and the remote python +
    working dir. Each created node runs ``python -m
    ray_tpu_torch.runtime.agent`` detached (nohup) on the next free host
    (a node type's ``"GPU"`` as ``--num-gpus``); terminate kills it there."""

    def __init__(
        self,
        head_address: str,
        hosts: List[str],
        *,
        ssh_user: str = "",
        ssh_key: str = "",
        remote_python: str = "python3",
        remote_dir: str = "~",
    ):
        self.head_address = head_address
        self.hosts = list(hosts)
        self.ssh_user = ssh_user
        self.ssh_key = ssh_key
        self.remote_python = remote_python
        self.remote_dir = remote_dir
        self._lock = threading.Lock()
        self._in_use: Dict[str, str] = {}   # host -> node type
        self._remote_pids: Dict[str, int] = {}  # host -> remote agent PID

    def _ssh_base(self, host: str) -> List[str]:
        cmd = ["ssh", "-o", "StrictHostKeyChecking=no", "-o", "ConnectTimeout=10"]
        if self.ssh_key:
            cmd += ["-i", self.ssh_key]
        target = f"{self.ssh_user}@{host}" if self.ssh_user else host
        return cmd + [target]

    def agent_command(self, node_type: NodeTypeConfig, host: str) -> str:
        """The remote shell command that starts one agent on ``host`` and
        prints its PID."""
        import json as _json
        import shlex as _shlex

        resources = dict(node_type.resources)
        cpus = resources.pop("CPU", 1)
        resources, gpus = split_gpus(resources)
        labels = _json.dumps({**node_type.labels, "rt_provider_id": host})
        gpu = " ".join(gpu_args(gpus))
        return (
            f"cd {self.remote_dir} && nohup {self.remote_python} -m "
            f"{AGENT_MODULE} --address {_shlex.quote(self.head_address)} "
            f"--num-cpus {cpus} {gpu + ' ' if gpu else ''}"
            f"--resources {_shlex.quote(_json.dumps(resources))} "
            f"--labels {_shlex.quote(labels)} "
            f">> ray_tpu_torch_agent.log 2>&1 & echo $!"
        )

    def create_nodes(self, node_type: NodeTypeConfig, count: int) -> List[str]:
        import subprocess as _sp

        created = []
        with self._lock:
            free = [h for h in self.hosts if h not in self._in_use]
        for host in free[:count]:
            agent = self.agent_command(node_type, host)
            res = _sp.run(self._ssh_base(host) + [agent], capture_output=True, text=True, timeout=60)
            if res.returncode == 0:
                with self._lock:
                    self._in_use[host] = node_type.name
                    # remember the remote PID: termination must kill OUR
                    # agent, not every ray_tpu_torch agent on a shared host
                    try:
                        self._remote_pids[host] = int(res.stdout.strip().splitlines()[-1])
                    except (ValueError, IndexError):
                        self._remote_pids[host] = 0
                created.append(host)
        return created

    def terminate_node(self, provider_node_id: str) -> None:
        import subprocess as _sp

        with self._lock:
            self._in_use.pop(provider_node_id, None)
            pid = self._remote_pids.pop(provider_node_id, 0)
        kill_cmd = (
            f"kill {pid} || true" if pid
            else f"pkill -f {AGENT_MODULE} || true"  # PID capture failed
        )
        _sp.run(
            self._ssh_base(provider_node_id) + [kill_cmd],
            capture_output=True, timeout=60,
        )

    def non_terminated_nodes(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._in_use)
