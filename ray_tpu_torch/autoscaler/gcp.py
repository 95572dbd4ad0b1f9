"""GCP TPU-VM node provider: slice-gang provisioning on Cloud TPU.

Rebuild of the reference's GCP provider specialized for TPU pods
(``python/ray/autoscaler/_private/gcp/node_provider.py`` + the TPU-pod
resources in ``python/ray/_private/accelerators/tpu.py:13-33``), behind a
MOCKABLE gcloud interface so the whole create→join→drain→delete lifecycle
unit-tests against a fake API (and, in tests here, against real local
agent processes standing in for the slice's hosts).

Gang semantics: a multi-host TPU slice is ONE provider node.  ``create``
provisions the TPU-VM (all hosts atomically — that is how Cloud TPU works)
and starts a node agent on EVERY host via ``gcloud ... ssh --worker=all``;
the slice is healthy only when ALL hosts joined the head within the
timeout, otherwise it is deleted (all-or-nothing — a device mesh must
never straddle a partial slice).  Each host carries slice-topology labels
(``ray_tpu.io/pod-type``, ``slice-id``, ``worker-index``) so STRICT gang
placement groups target one slice via ``pack_by_label``.
"""

from __future__ import annotations

import json
import shlex
import threading
import time
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.demand import NodeTypeConfig
from ray_tpu_torch.autoscaler.node_provider import (
    AGENT_MODULE,
    TPU_SLICE_TOPOLOGIES,
    NodeProvider,
)


class GcloudTpuAPI:
    """The mockable slice-lifecycle surface.  The real implementation shells
    out to ``gcloud compute tpus tpu-vm``; tests inject a fake."""

    def create_tpu_vm(
        self, name: str, zone: str, accelerator_type: str,
        runtime_version: str, labels: Dict[str, str],
    ) -> None:
        raise NotImplementedError

    def delete_tpu_vm(self, name: str, zone: str) -> None:
        raise NotImplementedError

    def list_tpu_vms(self, zone: str) -> List[dict]:
        """[{"name", "state", "labels"}] for TPU VMs in the zone."""
        raise NotImplementedError

    def run_on_all_workers(self, name: str, zone: str, command: str) -> None:
        """Execute a shell command on every host of the slice
        (``--worker=all``)."""
        raise NotImplementedError


class GcloudCLI(GcloudTpuAPI):
    """Real backend over the gcloud CLI (requires gcloud on PATH and an
    authenticated project)."""

    def __init__(self, project: str, gcloud: str = "gcloud", timeout_s: float = 600.0):
        self.project = project
        self.gcloud = gcloud
        self.timeout_s = timeout_s

    def _run(self, args: List[str], timeout: Optional[float] = None) -> str:
        import subprocess

        res = subprocess.run(
            [self.gcloud, "--project", self.project, *args],
            capture_output=True, text=True, timeout=timeout or self.timeout_s,
        )
        if res.returncode != 0:
            raise RuntimeError(f"gcloud {' '.join(args[:4])}... failed: {res.stderr.strip()}")
        return res.stdout

    def create_tpu_vm(self, name, zone, accelerator_type, runtime_version, labels):
        label_arg = ",".join(f"{k.replace('/', '_').replace('.', '-')}={v}" for k, v in labels.items())
        self._run(
            [
                "compute", "tpus", "tpu-vm", "create", name,
                "--zone", zone,
                "--accelerator-type", accelerator_type,
                "--version", runtime_version,
                *(["--labels", label_arg] if label_arg else []),
                "--quiet",
            ]
        )

    def delete_tpu_vm(self, name, zone):
        self._run(["compute", "tpus", "tpu-vm", "delete", name, "--zone", zone, "--quiet"])

    def list_tpu_vms(self, zone):
        out = self._run(["compute", "tpus", "tpu-vm", "list", "--zone", zone, "--format", "json"])
        return [
            {"name": row.get("name", "").rsplit("/", 1)[-1],
             "state": row.get("state", ""),
             "labels": row.get("labels", {})}
            for row in json.loads(out or "[]")
        ]

    def run_on_all_workers(self, name, zone, command):
        self._run(
            ["compute", "tpus", "tpu-vm", "ssh", name, "--zone", zone,
             "--worker=all", "--command", command],
        )


class GcpTpuNodeProvider(NodeProvider):
    """Slice-gang TPU-VM provider (see module docstring).

    ``live_slice_hosts(slice_id) -> int`` reports how many hosts of a slice
    have joined the head (the launcher binds it to the cluster's node-label
    view); when provided, create enforces the all-or-nothing gang join."""

    def __init__(
        self,
        head_address: str,
        *,
        zone: str,
        runtime_version: str = "tpu-ubuntu2204-base",
        api: Optional[GcloudTpuAPI] = None,
        project: str = "",
        name_prefix: str = "rt",
        remote_python: str = "python3",
        gang_join_timeout_s: float = 600.0,
        live_slice_hosts: Optional[Callable[[str], int]] = None,
    ):
        self.head_address = head_address
        self.zone = zone
        self.runtime_version = runtime_version
        self.api = api if api is not None else GcloudCLI(project)
        self.name_prefix = name_prefix
        self.remote_python = remote_python
        self.gang_join_timeout_s = gang_join_timeout_s
        self.live_slice_hosts = live_slice_hosts
        self._lock = threading.Lock()
        self._slices: Dict[str, str] = {}  # slice name -> node type name
        self._seq = 0
        self._seq_reconciled = False

    def _reconcile_with_cloud(self) -> None:
        """One-time on first use: adopt surviving slices from a previous
        head incarnation (matched by the rt-cluster label / name prefix) and
        advance the name sequence past them — a restarted head must neither
        collide with nor orphan live TPU VMs."""
        if self._seq_reconciled:
            return
        self._seq_reconciled = True
        try:
            listed = self.api.list_tpu_vms(self.zone)
        except Exception:  # noqa: BLE001 — API down: first create will surface it
            return
        with self._lock:
            for row in listed:
                name = row.get("name", "")
                if not name.startswith(self.name_prefix + "-"):
                    continue
                rest = name[len(self.name_prefix) + 1:]
                pod_type, _, seq_str = rest.rpartition("-")
                try:
                    self._seq = max(self._seq, int(seq_str))
                except ValueError:
                    continue
                if pod_type and row.get("state") not in ("DELETING", "TERMINATED"):
                    self._slices.setdefault(name, pod_type)

    # ------------------------------------------------------------------
    def agent_command(self, slice_id: str, pod_type: str, chips_per_host: int) -> str:
        """The per-host agent bring-up command (runs on EVERY worker via
        ``--worker=all``).  The agent itself reads ``TPU_WORKER_ID`` (the
        Cloud TPU-provided per-host index) into its ``worker-index`` label —
        no per-host command templating needed."""
        labels = {
            "ray_tpu.io/pod-type": pod_type,
            "ray_tpu.io/slice-id": slice_id,
            # all hosts share the slice's provider id so the autoscaler's
            # busy/idle view sees the slice as one schedulable unit
            "rt_provider_id": slice_id,
        }
        resources = {"TPU": float(chips_per_host), f"TPU-{pod_type}-host": 1.0}
        return (
            f"nohup {self.remote_python} -m {AGENT_MODULE} "
            f"--address {shlex.quote(self.head_address)} "
            f"--resources {shlex.quote(json.dumps(resources))} "
            f"--labels {shlex.quote(json.dumps(labels))} "
            f">> /tmp/ray_tpu_agent.log 2>&1 &"
        )

    def create_nodes(self, node_type: NodeTypeConfig, count: int) -> List[str]:
        topo = TPU_SLICE_TOPOLOGIES.get(node_type.name)
        if topo is None:
            raise ValueError(
                f"unknown TPU pod type {node_type.name!r}; known: {sorted(TPU_SLICE_TOPOLOGIES)}"
            )
        self._reconcile_with_cloud()
        created: List[str] = []
        for _ in range(count):
            with self._lock:
                self._seq += 1
                name = f"{self.name_prefix}-{node_type.name}-{self._seq}"
            self.api.create_tpu_vm(
                name, self.zone,
                accelerator_type=node_type.name,
                runtime_version=self.runtime_version,
                labels={"rt-cluster": self.name_prefix, "rt-pod-type": node_type.name},
            )
            try:
                self.api.run_on_all_workers(
                    name, self.zone,
                    self.agent_command(name, node_type.name, topo["chips_per_host"]),
                )
            except Exception:
                # all-or-nothing: a slice that can't start its agents is
                # deleted, never left half-registered
                try:
                    self.api.delete_tpu_vm(name, self.zone)
                except Exception:  # noqa: BLE001
                    pass
                raise
            with self._lock:
                self._slices[name] = node_type.name
            created.append(name)
            if self.live_slice_hosts is not None:
                # enforce the gang OFF-THREAD: create_nodes runs under the
                # autoscaler's update lock and must not stall every scaling
                # decision for gang_join_timeout_s (reference: NodeLauncher
                # threads); on timeout the watcher deletes the slice.
                threading.Thread(
                    target=self._enforce_gang_join,
                    args=(name, topo["hosts"]),
                    name=f"gang-join-{name}",
                    daemon=True,
                ).start()
        return created

    def _enforce_gang_join(self, slice_id: str, expected_hosts: int) -> None:
        deadline = time.monotonic() + self.gang_join_timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if slice_id not in self._slices:
                    return  # terminated meanwhile
            if self.live_slice_hosts(slice_id) >= expected_hosts:
                return
            time.sleep(0.25)
        # all-or-nothing: the slice never fully joined — tear it down
        import logging

        logging.getLogger(__name__).warning(
            "gcp-tpu: slice %s joined %d/%d hosts within %.0fs; deleting",
            slice_id, self.live_slice_hosts(slice_id), expected_hosts,
            self.gang_join_timeout_s,
        )
        try:
            self.terminate_node(slice_id)
        except Exception:  # noqa: BLE001
            pass

    def terminate_node(self, provider_node_id: str) -> None:
        with self._lock:
            self._slices.pop(provider_node_id, None)
        self.api.delete_tpu_vm(provider_node_id, self.zone)

    def non_terminated_nodes(self) -> Dict[str, str]:
        self._reconcile_with_cloud()
        with self._lock:
            known = dict(self._slices)
        try:
            listed = {row["name"] for row in self.api.list_tpu_vms(self.zone)
                      if row.get("state") not in ("DELETING", "TERMINATED")}
        except Exception:  # noqa: BLE001 — API hiccup: trust local view
            return known
        return {name: t for name, t in known.items() if name in listed}


def live_slice_hosts_fn(cluster) -> Callable[[str], int]:
    """Bind the gang-join check to the head's node-label view."""

    def count(slice_id: str) -> int:
        return sum(
            1 for node in list(cluster.nodes.values())
            if not node.dead
            and (getattr(node, "labels", None) or {}).get("ray_tpu.io/slice-id") == slice_id
        )

    return count


class FakeGcloudTpuAPI(GcloudTpuAPI):
    """Unit-test double: records every call; ``run_on_all_workers`` executes
    the provider's REAL agent command (the port's agent) locally once per
    simulated host (with TPU_WORKER_ID set), so created slices genuinely
    join the head and the full create→join→drain→delete cycle is exercised
    without GCP."""

    def __init__(self, hosts_by_type: Optional[Dict[str, int]] = None, spawn: bool = True):
        self.calls: List[tuple] = []
        self.vms: Dict[str, dict] = {}
        self.spawn = spawn
        self._procs: Dict[str, list] = {}
        self._hosts_by_type = hosts_by_type or {}

    def create_tpu_vm(self, name, zone, accelerator_type, runtime_version, labels):
        self.calls.append(("create", name, zone, accelerator_type, runtime_version))
        self.vms[name] = {
            "name": name, "state": "READY", "labels": dict(labels),
            "accelerator_type": accelerator_type,
        }

    def delete_tpu_vm(self, name, zone):
        self.calls.append(("delete", name, zone))
        self.vms.pop(name, None)
        for proc in self._procs.pop(name, []):
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                except Exception:  # noqa: BLE001
                    proc.kill()

    def list_tpu_vms(self, zone):
        self.calls.append(("list", zone))
        return [dict(vm) for vm in self.vms.values()]

    def run_on_all_workers(self, name, zone, command):
        self.calls.append(("ssh_all", name, zone, command))
        if not self.spawn:
            return
        import os
        import subprocess
        import sys

        vm = self.vms[name]
        pod_type = vm["accelerator_type"]
        hosts = self._hosts_by_type.get(
            pod_type, TPU_SLICE_TOPOLOGIES.get(pod_type, {"hosts": 1})["hosts"]
        )
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for worker_index in range(hosts):
            env = dict(os.environ)
            env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
            env["TPU_WORKER_ID"] = str(worker_index)
            # run the EXACT command the real path would ship over ssh,
            # substituting THIS interpreter for whatever remote python the
            # command names (token between "nohup " and " -m" — a plain
            # str.replace would mangle configured paths containing
            # "python3"), dropping the trailing "&" and exec-ing so the
            # Popen handle IS the agent (a forked sh would orphan it)
            head, sep, tail = command.partition(" -m ")
            if sep and head.startswith("nohup "):
                local_cmd = f"nohup {shlex.quote(sys.executable)}{sep}{tail}"
            else:
                local_cmd = command
            proc = subprocess.Popen(
                ["/bin/sh", "-c", "exec " + local_cmd.rstrip("& \t")],
                env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            )
            self._procs.setdefault(name, []).append(proc)
