"""Kubernetes node provider: agent pods on a cluster (KubeRay role).

Rebuild of the reference's KubeRay integration
(``python/ray/autoscaler/_private/kuberay/node_provider.py`` — the
autoscaler drives pod creation through the RayCluster CR) for this
runtime's flat provider interface: each provider node is ONE pod running
``python -m ray_tpu_torch.runtime.agent`` pointed at the head, labeled so a
restarted head re-adopts its fleet.  GKE is where real TPU fleets run;
TPU node types ride GKE's TPU node pools — the pod requests
``google.com/tpu`` and reads the ``TPU_WORKER_ID``/``TPU_WORKER_HOSTNAMES``
env GKE injects for slice topology, the same labels the GCP TPU-VM
provider stamps.

The Kubernetes surface is MOCKABLE (``KubernetesAPI``): the real backend
shells out to ``kubectl`` (present on any GKE node image; no python k8s
client dependency), tests inject a fake and exercise the whole
create→list→adopt→terminate lifecycle.
"""

from __future__ import annotations

import json
import shlex
import threading
from typing import Dict, List, Optional

from ray_tpu_torch.autoscaler.demand import NodeTypeConfig
from ray_tpu_torch.autoscaler.node_provider import (
    AGENT_MODULE,
    TPU_SLICE_TOPOLOGIES,
    NodeProvider,
    gpu_args,
    split_gpus,
)

#: pod labels (the reconcile key — a restarted head must re-adopt its pods)
CLUSTER_LABEL = "ray-tpu.io/cluster"
TYPE_LABEL = "ray-tpu.io/node-type"


class KubernetesAPI:
    """The mockable pod-lifecycle surface."""

    def create_pod(self, manifest: dict) -> None:
        raise NotImplementedError

    def delete_pod(self, name: str) -> None:
        raise NotImplementedError

    def list_pods(self, label_selector: str) -> List[dict]:
        """[{"name", "phase", "labels"}] for pods matching the selector."""
        raise NotImplementedError


class KubectlAPI(KubernetesAPI):
    """Real backend over the kubectl CLI (in-cluster service account or a
    kubeconfig — whatever kubectl resolves)."""

    def __init__(self, namespace: str = "default", kubectl: str = "kubectl",
                 timeout_s: float = 300.0):
        self.namespace = namespace
        self.kubectl = kubectl
        self.timeout_s = timeout_s

    def _run(self, args: List[str], stdin: Optional[str] = None) -> str:
        import subprocess

        res = subprocess.run(
            [self.kubectl, "-n", self.namespace, *args],
            input=stdin, capture_output=True, text=True, timeout=self.timeout_s,
        )
        if res.returncode != 0:
            raise RuntimeError(f"kubectl {' '.join(args[:3])}... failed: {res.stderr.strip()}")
        return res.stdout

    def create_pod(self, manifest: dict) -> None:
        # `create`, not `apply`: creation must HARD-FAIL on a name
        # collision (apply is a silent no-op on an identical pod, which
        # would let a desynced name sequence under-provision forever)
        self._run(["create", "-f", "-"], stdin=json.dumps(manifest))

    def delete_pod(self, name: str) -> None:
        self._run(["delete", "pod", name, "--wait=false", "--ignore-not-found=true"])

    def list_pods(self, label_selector: str) -> List[dict]:
        out = self._run(["get", "pods", "-l", label_selector, "-o", "json"])
        items = json.loads(out or "{}").get("items", [])
        return [
            {
                "name": it["metadata"]["name"],
                "phase": it.get("status", {}).get("phase", ""),
                "labels": it["metadata"].get("labels", {}),
            }
            for it in items
        ]


class KubernetesNodeProvider(NodeProvider):
    """One agent pod per provider node (see module docstring)."""

    def __init__(
        self,
        head_address: str,
        *,
        api: Optional[KubernetesAPI] = None,
        namespace: str = "default",
        image: str = "python:3.12-slim",
        cluster_name: str = "rt",
        remote_python: str = "python",
        service_account: str = "",
        pod_overrides: Optional[dict] = None,
    ):
        self.head_address = head_address
        self.api = api if api is not None else KubectlAPI(namespace)
        self.image = image
        self.cluster_name = cluster_name
        self.remote_python = remote_python
        self.service_account = service_account
        self.pod_overrides = pod_overrides or {}
        self._lock = threading.Lock()
        self._pods: Dict[str, str] = {}  # pod name -> node type name
        self._seq = 0
        self._reconciled = False

    # ------------------------------------------------------------------
    def _selector(self) -> str:
        return f"{CLUSTER_LABEL}={self.cluster_name}"

    def _reconcile(self) -> None:
        """First use after a head restart: adopt surviving pods and advance
        the name sequence past them (never collide, never orphan).  Stays
        un-latched until a listing SUCCEEDS — a transiently-down API must
        not leave the sequence at 0 forever."""
        if self._reconciled:
            return
        try:
            pods = self.api.list_pods(self._selector())
        except Exception:  # noqa: BLE001 — API down: retry on next use
            return
        self._reconciled = True
        with self._lock:
            for pod in pods:
                name = pod.get("name", "")
                seq_str = name.rsplit("-", 1)[-1]
                try:
                    self._seq = max(self._seq, int(seq_str))
                except ValueError:
                    continue
                node_type = (pod.get("labels") or {}).get(TYPE_LABEL)
                if node_type and pod.get("phase") not in ("Succeeded", "Failed"):
                    self._pods.setdefault(name, node_type)

    # ------------------------------------------------------------------
    def agent_command(self, name: str, node_type: NodeTypeConfig) -> str:
        labels = dict(node_type.labels)
        labels.setdefault("ray_tpu.io/node-type", node_type.name)
        # the busy/idle mapping key: the autoscaler maps cluster nodes back
        # to provider ids through this label (autoscaler._load_snapshot) —
        # without it every pod reads permanently idle and gets reaped
        # mid-computation at idle_timeout
        labels.setdefault("rt_provider_id", name)
        topo = TPU_SLICE_TOPOLOGIES.get(node_type.name)
        if topo is not None:
            # GKE TPU node pool: worker index/slice id arrive via the
            # TPU_WORKER_ID env GKE injects (read by the agent, same as the
            # TPU-VM provider's labels)
            labels.setdefault("ray_tpu.io/pod-type", node_type.name)
        resources, gpus = split_gpus(node_type.resources)
        gpu = "".join(f"{a} " for a in gpu_args(gpus))
        return (
            f"{self.remote_python} -m {AGENT_MODULE} "
            f"--address {shlex.quote(self.head_address)} {gpu}"
            f"--resources {shlex.quote(json.dumps(resources))} "
            f"--labels {shlex.quote(json.dumps(labels))}"
        )

    def pod_manifest(self, name: str, node_type: NodeTypeConfig) -> dict:
        resources = dict(node_type.resources)
        limits: Dict[str, object] = {}
        cpu = resources.get("CPU")
        if cpu:
            # k8s quantity syntax; fractional CPUs become millicores (a
            # bare int() would truncate 0.5 to a zero-quota "0")
            limits["cpu"] = str(int(cpu)) if float(cpu).is_integer() else f"{int(cpu * 1000)}m"
        if resources.get("TPU"):
            # GKE's TPU device plugin resource name
            limits["google.com/tpu"] = str(int(resources["TPU"]))
        if resources.get("GPU"):
            # the NVIDIA device plugin's resource name: the agent's
            # --num-gpus refuses to start without the cards in the pod
            limits["nvidia.com/gpu"] = str(int(resources["GPU"]))
        spec: dict = {
            "restartPolicy": "Never",  # the autoscaler owns replacement
            "containers": [
                {
                    "name": "rt-agent",
                    "image": self.image,
                    "command": ["/bin/sh", "-c", self.agent_command(name, node_type)],
                    **({"resources": {"limits": limits, "requests": dict(limits)}} if limits else {}),
                }
            ],
        }
        if self.service_account:
            spec["serviceAccountName"] = self.service_account
        spec.update(self.pod_overrides.get("spec", {}))
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": name,
                "labels": {
                    CLUSTER_LABEL: self.cluster_name,
                    TYPE_LABEL: node_type.name,
                    **self.pod_overrides.get("labels", {}),
                },
            },
            "spec": spec,
        }

    # ------------------------------------------------------------------
    def create_nodes(self, node_type: NodeTypeConfig, count: int) -> List[str]:
        self._reconcile()
        created: List[str] = []
        for _ in range(count):
            with self._lock:
                self._seq += 1
                name = f"{self.cluster_name}-{node_type.name}-{self._seq}"
            self.api.create_pod(self.pod_manifest(name, node_type))
            with self._lock:
                self._pods[name] = node_type.name
            created.append(name)
        return created

    def terminate_node(self, provider_node_id: str) -> None:
        with self._lock:
            self._pods.pop(provider_node_id, None)
        try:
            self.api.delete_pod(provider_node_id)
        except Exception:  # noqa: BLE001 — already gone: reconcile agrees
            pass

    def non_terminated_nodes(self) -> Dict[str, str]:
        self._reconcile()
        try:
            pods = self.api.list_pods(self._selector())
        except Exception:  # noqa: BLE001 — API down: report the local view
            with self._lock:
                return dict(self._pods)
        out: Dict[str, str] = {}
        with self._lock:
            for pod in pods:
                if pod.get("phase") in ("Succeeded", "Failed"):
                    self._pods.pop(pod.get("name", ""), None)
                    continue
                node_type = (pod.get("labels") or {}).get(TYPE_LABEL)
                if node_type:
                    out[pod["name"]] = node_type
                    self._pods.setdefault(pod["name"], node_type)
        return out
