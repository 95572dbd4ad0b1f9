"""Dashboard head: threaded HTTP server over the state API.

The port's copy of ``ray_tpu/dashboard/head.py``: the same routes and
payloads over the port's one-node runtime.  There is no multi-host head
service and no remote node here (ROADMAP item 10), so ``/api/transfers``
lists no node and the peer byte counters read 0, as the JAX package's do
without a head service; ``/api/autoscaler`` reports the summary of an
attached ``autoscaler.Monitor``, and none without one.

Routes (reference parity: ``dashboard/modules/{node,actor,job,metrics,
event,healthz}`` REST surfaces + ``python/ray/util/state`` aggregation):

  GET  /api/version                  — framework version + session
  GET  /api/healthz                  — liveness
  GET  /api/nodes | /api/actors | /api/tasks | /api/objects
       /api/placement_groups        — state-API listings
  GET  /api/cluster_status          — resource totals/availability
  GET  /api/overload                — admission bounds, queue depths, sheds
  GET  /api/events                  — structured event log
  GET  /api/summary/tasks|actors|objects
  GET  /metrics                     — Prometheus text exposition
  POST /api/jobs/                   — submit job {entrypoint, ...}
  GET  /api/jobs/                   — list jobs
  GET  /api/jobs/<id>               — job detail
  GET  /api/jobs/<id>/logs          — captured driver logs
  POST /api/jobs/<id>/stop          — stop a running job
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse


class DashboardHead:
    def __init__(self, cluster, host: str = "127.0.0.1", port: int = 0):
        self.cluster = cluster
        from ray_tpu_torch.job.manager import JobManager

        self.job_manager = JobManager(cluster)
        head = self

        class Handler(BaseHTTPRequestHandler):
            # silence the default stderr access log
            def log_message(self, *args):
                pass

            def _send(self, code: int, payload, content_type: str = "application/json"):
                body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    head._handle_get(self)
                except BrokenPipeError:
                    pass
                except Exception as exc:  # noqa: BLE001
                    self._send(500, {"error": repr(exc)})

            def do_POST(self):
                try:
                    head._handle_post(self)
                except BrokenPipeError:
                    pass
                except Exception as exc:  # noqa: BLE001
                    self._send(500, {"error": repr(exc)})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, name="dashboard-head", daemon=True)
        self._thread.start()
        # the head node's own utilization samples (agents piggyback theirs
        # on resource_report; the head has no agent, so sample locally)
        self._stop_sampler = threading.Event()
        threading.Thread(target=self._self_sample_loop, name="dashboard-sampler", daemon=True).start()

    def _self_sample_loop(self) -> None:
        from collections import deque

        from ray_tpu_torch.dashboard.reporter import SystemSampler

        sampler = SystemSampler()
        head_node = self.cluster.head_node
        # cluster-wide rate series (tasks/s, transfer B/s): sampled from the
        # counters the runtime already keeps, ~15 min of 2s points
        self.cluster_history: deque = deque(maxlen=450)
        # Baseline at thread start, not at the first tick: work finishing
        # inside the first 2 s window (fast tests, bursty startup jobs) must
        # show up in the first delta instead of vanishing into the baseline.
        prev_tasks = self._terminal_task_count()
        prev_bytes = self.cluster.transfer_bytes + self._peer_bytes_received()
        prev_t = time.monotonic()
        while not self._stop_sampler.wait(2.0):
            if head_node is not None:
                self.cluster.metrics_history.add(head_node.node_id.hex(), sampler.sample())
            now = time.monotonic()
            dt = max(1e-6, now - prev_t)
            tasks = self._terminal_task_count()
            xfer = self.cluster.transfer_bytes + self._peer_bytes_received()
            point = {
                "ts": time.time(),
                "tasks_per_s": max(0.0, (tasks - prev_tasks) / dt),
                "transfer_bytes_per_s": max(0.0, (xfer - prev_bytes) / dt),
            }
            prev_tasks, prev_bytes, prev_t = tasks, xfer, now
            self.cluster_history.append(point)

    def _terminal_task_count(self) -> float:
        from ray_tpu_torch.observability.metrics import global_registry

        try:
            m = global_registry().counter("tasks_terminal_total")
            return float(sum(v for _tags, v in m.series()))
        except Exception:  # noqa: BLE001
            return 0.0

    def _peer_bytes_received(self) -> float:
        try:
            hs = getattr(self.cluster, "head_service", None)
            if hs is None:
                return 0.0
            return float(hs.data_client.stats.snapshot()["bytes_received"])
        except Exception:  # noqa: BLE001
            return 0.0

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def shutdown(self) -> None:
        self._stop_sampler.set()
        self.job_manager.shutdown()
        self._server.shutdown()
        self._server.server_close()

    # ------------------------------------------------------------------
    def _handle_get(self, req) -> None:
        from ray_tpu_torch import state as state_api
        from ray_tpu_torch._version import version
        from ray_tpu_torch.observability.events import global_event_manager
        from ray_tpu_torch.observability.metrics import global_registry

        parsed = urlparse(req.path)
        path = parsed.path.rstrip("/")
        query = parse_qs(parsed.query)
        limit = int(query.get("limit", ["1000"])[0])

        if not path:
            from ray_tpu_torch.dashboard.ui import INDEX_HTML

            req._send(200, INDEX_HTML.encode(), "text/html; charset=utf-8")
        elif path == "/api/version":
            req._send(200, {"version": version, "session_dir": self.cluster.session_dir})
        elif path == "/api/healthz":
            req._send(200, {"status": "ok"})
        elif path == "/api/nodes":
            req._send(200, {"nodes": state_api.list_nodes(limit=limit)})
        elif path == "/api/actors":
            req._send(200, {"actors": state_api.list_actors(limit=limit)})
        elif path == "/api/tasks":
            req._send(200, {"tasks": state_api.list_tasks(limit=limit)})
        elif path == "/api/objects":
            req._send(200, {"objects": state_api.list_objects(limit=limit)})
        elif path == "/api/placement_groups":
            req._send(200, {"placement_groups": state_api.list_placement_groups(limit=limit)})
        elif path == "/api/cluster_status":
            req._send(200, self._cluster_status())
        elif path == "/api/logs/search":
            pattern = query.get("q", [""])[0]
            node_q = query.get("node", [None])[0]
            req._send(
                200,
                {"matches": self.cluster.node_logs.search(
                    pattern, limit=limit, node_hex=node_q
                )},
            )
        elif path == "/api/stack":
            timeout = float(query.get("timeout", ["5"])[0])
            req._send(200, self.cluster.dump_cluster_stacks(timeout=timeout))
        elif path == "/api/transfers":
            req._send(200, self._transfer_stats())
        elif path == "/api/pulls":
            req._send(200, self._pull_stats())
        elif path == "/api/leases":
            req._send(200, self._lease_stats())
        elif path == "/api/autoscaler":
            req._send(200, self._autoscaler_status())
        elif path == "/api/overload":
            req._send(200, self.cluster.overload_snapshot())
        elif path == "/api/requests":
            from ray_tpu_torch.observability import reqtrace

            req._send(
                200,
                reqtrace.global_trace_store().snapshot(limit=min(limit, 200)),
            )
        elif path == "/api/plans":
            req._send(200, self._plan_stats())
        elif path == "/api/train":
            req._send(200, self._train_stats())
        elif path == "/api/memory":
            req._send(200, self._memory_summary())
        elif path == "/api/data/datasets":
            from ray_tpu_torch.data.executor import recent_executions

            req._send(200, {"executions": recent_executions()})
        elif path.startswith("/api/actors/"):
            req._send(200, self._actor_detail(path[len("/api/actors/"):]))
        elif path.startswith("/api/tasks/"):
            req._send(200, self._task_detail(path[len("/api/tasks/"):]))
        elif path == "/api/metrics_history":
            minutes = float(query.get("minutes", ["15"])[0])
            req._send(200, {"nodes": self.cluster.metrics_history.all_series(minutes)})
        elif path == "/api/metrics/cluster_history":
            cutoff = time.time() - float(query.get("minutes", ["15"])[0]) * 60
            pts = [p for p in getattr(self, "cluster_history", ()) if p["ts"] >= cutoff]
            req._send(200, {"points": pts})
        elif path.startswith("/api/nodes/") and path.endswith("/metrics"):
            node_hex = self._resolve_node_hex(path[len("/api/nodes/"): -len("/metrics")])
            minutes = float(query.get("minutes", ["15"])[0])
            req._send(200, {"node": node_hex, "series": self.cluster.metrics_history.series(node_hex, minutes)})
        elif path.startswith("/api/nodes/") and path.endswith("/logs"):
            node_hex = self._resolve_node_hex(path[len("/api/nodes/"): -len("/logs")])
            lines = int(query.get("lines", ["200"])[0])
            req._send(200, {"node": node_hex, "lines": self.cluster.node_logs.tail(node_hex, lines)})
        elif path == "/api/events":
            req._send(
                200,
                {"events": [e.to_dict() for e in global_event_manager().list_events(limit=limit)]},
            )
        elif path.startswith("/api/summary/"):
            kind = path.rsplit("/", 1)[1]
            fn = {
                "tasks": state_api.summarize_tasks,
                "actors": state_api.summarize_actors,
                "objects": state_api.summarize_objects,
            }.get(kind)
            if fn is None:
                req._send(404, {"error": f"unknown summary {kind!r}"})
            else:
                req._send(200, fn())
        elif path == "/api/timeline":
            from ray_tpu_torch.observability.timeline import chrome_trace

            # ?limit= caps the event count (downloads default high); ?since_s=
            # keeps only spans ending in the trailing window — the inline
            # Gantt polls with since_s=120&limit=400 so refreshes stay cheap;
            # ?tracing=1 merges the tracing layer's spans into the trace
            events = self.cluster.control.task_events.list_events(limit=100_000)
            if query.get("tracing", ["0"])[0] in ("1", "true"):
                events = events + self.cluster.control.spans.list_events(limit=100_000)
            trace = chrome_trace(events)
            # the merged stream interleaves two independently-ordered
            # stores: sort by start time so the newest-N `limit` below
            # keeps the newest slices rather than whichever store was
            # concatenated last
            trace.sort(key=lambda e: e["ts"])
            since_s = query.get("since_s")
            if since_s:
                cutoff = (time.time() - float(since_s[0])) * 1e6
                trace = [e for e in trace if e["ts"] + e["dur"] >= cutoff]
            if "limit" in query:
                # newest-N of the WINDOW (limit-before-window would silently
                # blank the older part of a busy Gantt)
                trace = trace[-limit:]
            req._send(200, trace)
        elif path == "/metrics":
            req._send(200, global_registry().render_prometheus().encode(), "text/plain; version=0.0.4")
        elif path == "/api/serve/applications":
            from ray_tpu_torch.serve import api as serve_api

            if serve_api._controller is None:
                # read-only endpoint: report not-started, don't boot serve
                req._send(200, {"deployments": {}, "proxy_url": None, "started": False})
            else:
                try:
                    from ray_tpu_torch import serve

                    req._send(200, serve.status())
                except Exception as exc:
                    req._send(500, {"error": str(exc)})
        elif path == "/api/jobs":
            req._send(200, {"jobs": self.job_manager.list_jobs()})
        elif path.startswith("/api/jobs/"):
            rest = path[len("/api/jobs/"):]
            if rest.endswith("/logs"):
                sub_id = rest[: -len("/logs")]
                logs = self.job_manager.get_logs(sub_id)
                if logs is None:
                    req._send(404, {"error": f"job {sub_id!r} not found"})
                else:
                    req._send(200, {"logs": logs})
            else:
                info = self.job_manager.get_job(rest)
                if info is None:
                    req._send(404, {"error": f"job {rest!r} not found"})
                else:
                    req._send(200, info)
        else:
            req._send(404, {"error": f"no route {path!r}"})

    def _handle_post(self, req) -> None:
        path = urlparse(req.path).path.rstrip("/")
        length = int(req.headers.get("Content-Length", 0))
        body = json.loads(req.rfile.read(length) or b"{}") if length else {}

        if path == "/api/jobs":
            entrypoint = body.get("entrypoint")
            if not entrypoint:
                req._send(400, {"error": "entrypoint required"})
                return
            sub_id = self.job_manager.submit_job(
                entrypoint,
                runtime_env=body.get("runtime_env"),
                metadata=body.get("metadata"),
                submission_id=body.get("submission_id"),
            )
            req._send(200, {"submission_id": sub_id})
        elif path.startswith("/api/jobs/") and path.endswith("/stop"):
            sub_id = path[len("/api/jobs/"): -len("/stop")]
            ok = self.job_manager.stop_job(sub_id)
            req._send(200 if ok else 404, {"stopped": ok})
        elif path.startswith("/api/workflows/events"):
            # HTTP workflow trigger (parity: HTTPEventProvider — an external
            # system resumes a waiting workflow by POSTing the event payload)
            from urllib.parse import unquote

            from ray_tpu_torch.workflow.events import deliver_event, has_waiters

            name = unquote(path[len("/api/workflows/events"):].lstrip("/"))
            if not name:
                req._send(400, {"error": "event name required"})
            elif not has_waiters(name):
                # dropping unmatched events keeps the head unbounded-growth
                # safe and tells the caller the trigger reached nobody
                req._send(404, {"error": f"no workflow is waiting on {name!r}"})
            else:
                deliver_event(name, body)
                req._send(200, {"delivered": name})
        elif path == "/api/serve/applications":
            # declarative deploy (parity: serve REST API PUT /applications)
            try:
                from ray_tpu_torch import serve

                deployed = serve.run_config(body)
                req._send(200, {"deployed": deployed})
            except Exception as exc:
                req._send(400, {"error": str(exc)})
        else:
            req._send(404, {"error": f"no route {path!r}"})

    def _resolve_node_hex(self, prefix: str) -> str:
        """Accept full or prefix node ids in URLs."""
        for nid in list(self.cluster.nodes):
            h = nid.hex()
            if h.startswith(prefix):
                return h
        return prefix

    # ------------------------------------------------------------------
    def _transfer_stats(self) -> dict:
        """Live data-plane + device-plane counters per node (the head
        service's TransferStats and DeviceStats).  Agents piggyback
        snapshots on resource_report; the head reads its own.

        The port has neither agents nor a head service: no node has a data
        server to report, as in the JAX package before ``start_head_service``."""
        return {"nodes": {}}

    def _autoscaler_status(self) -> dict:
        """`rt nodes` / GET /api/autoscaler: per-node lifecycle state
        (ALIVE / DRAINING / DEAD), drain reports with evacuation counts,
        head-restart count, and the live autoscaler summary when a monitor
        is attached."""
        cluster = self.cluster
        scheduler = cluster.cluster_scheduler
        nodes = []
        for info in cluster.control.nodes.all_nodes():
            state = info.state.value
            if state == "ALIVE" and scheduler.is_draining(info.node_id):
                state = "DRAINING"
            nodes.append(
                {
                    "node_id": info.node_id.hex(),
                    "state": state,
                    "address": info.address,
                    "resources": info.resources_total,
                    "incarnation": cluster.control.nodes.incarnation_of(info.node_id),
                    "is_head": (
                        cluster.head_node is not None
                        and info.node_id == cluster.head_node.node_id
                    ),
                }
            )
        monitor = getattr(cluster, "autoscaler_monitor", None)
        fence_events = list(getattr(cluster, "fence_events", ()))
        fence_by_kind: dict = {}
        for fe in fence_events:
            fence_by_kind[fe.get("kind", "?")] = fence_by_kind.get(fe.get("kind", "?"), 0) + 1
        return {
            "nodes": nodes,
            "drains": list(cluster.drain_reports),
            "head_restarts": cluster.head_restarts,
            "autoscaler": monitor.autoscaler.summary() if monitor is not None else None,
            # gray-failure counters: fenced frames by kind + the
            # owner-side watchdog's deadline/hedge totals
            "fenced_frames": getattr(cluster, "fence_events_total", len(fence_events)),
            "fenced_by_kind": fence_by_kind,
            "watchdog": cluster.watchdog.snapshot(),
        }

    def _pull_stats(self) -> dict:
        """`rt pulls`: the PullManager's live admission/dedup counters, the
        broadcast planner's plan snapshots, the head data server's frame
        cache hit rate, plus the scheduler's locality hit/miss byte totals
        — together they answer "is the cluster moving bytes it didn't have
        to?"."""
        from ray_tpu_torch.observability import metric_defs

        frame_cache = {"hits": 0, "misses": 0}
        head_service = getattr(self.cluster, "head_service", None)
        if head_service is not None:
            stats = head_service.data_server.stats
            frame_cache = {
                "hits": stats.frame_cache_hits,
                "misses": stats.frame_cache_misses,
            }
        return {
            "pull_manager": self.cluster.pull_manager.snapshot(),
            "broadcast": self.cluster.pull_manager.broadcast_snapshot(),
            "frame_cache": frame_cache,
            "locality": {
                "hit_bytes": metric_defs.SCHEDULER_LOCALITY_BYTES.get({"result": "hit"}),
                "miss_bytes": metric_defs.SCHEDULER_LOCALITY_BYTES.get({"result": "miss"}),
            },
        }

    def _lease_stats(self) -> dict:
        """`rt leases` / GET /api/leases: active worker leases (per-shape
        cached dispatch routes), lifetime grant/reuse/spillback churn,
        direct-push transport split, and the actor direct-route totals —
        together they answer "is the head off the steady-state hot path?"."""
        from ray_tpu_torch.observability import metric_defs

        leases = self.cluster.lease_manager.snapshot()
        return {
            "leases": leases,
            "actor_routes": self.cluster.actor_route_stats(),
            "head": {
                "scheduling_decisions": self.cluster.cluster_scheduler.num_picks,
                "rpcs_avoided": metric_defs.HEAD_RPCS_AVOIDED.get(),
            },
            "pushes": {
                "inproc": metric_defs.DIRECT_PUSHES.get({"transport": "inproc"}),
                "data_plane": metric_defs.DIRECT_PUSHES.get({"transport": "data_plane"}),
                "actor_direct": metric_defs.DIRECT_PUSHES.get({"transport": "actor_direct"}),
            },
        }

    def _plan_stats(self) -> dict:
        """`rt plans`: installed compiled-execution-plan snapshots (stages,
        channel layout, state, iteration counts) plus the process-wide
        channel traffic/occupancy counters — 'is the compiled hot path
        actually carrying the iterations?'."""
        from ray_tpu_torch.observability import metric_defs
        from ray_tpu_torch.runtime import channel_manager

        dev = channel_manager.device_channel_stats()
        return {
            "plans": [
                p.snapshot() for p in list(self.cluster.compiled_plans.values())
            ],
            "totals": {
                "executions_ok": metric_defs.COMPILED_PLAN_EXECUTIONS.get({"state": "ok"}),
                "executions_error": metric_defs.COMPILED_PLAN_EXECUTIONS.get({"state": "error"}),
                "channel_bytes_sent": metric_defs.COMPILED_CHANNEL_BYTES.get({"direction": "sent"}),
                "channel_bytes_received": metric_defs.COMPILED_CHANNEL_BYTES.get({"direction": "received"}),
                "channel_occupancy": metric_defs.COMPILED_CHANNEL_OCCUPANCY.get(),
                "device_channel_bytes_sent": metric_defs.COMPILED_DEVICE_CHANNEL_BYTES.get(
                    {"direction": "sent"}
                ),
                "device_channel_bytes_received": metric_defs.COMPILED_DEVICE_CHANNEL_BYTES.get(
                    {"direction": "received"}
                ),
                "device_channel_occupancy": dev["occupied_slots"],
                "hbm_resident_bytes": dev["hbm_resident_bytes"],
                "stage_group_executions": metric_defs.PLAN_STAGE_GROUP_EXECUTIONS.get(),
            },
        }

    def _train_stats(self) -> dict:
        """`rt train`: every registered training gang's live status (size,
        step, last checkpoint, resize/repair history) plus the process-wide
        training counters — 'is the gang making steps, and what did it
        survive?'."""
        from ray_tpu_torch.observability import metric_defs

        jobs = []
        for name in sorted(getattr(self.cluster, "train_controllers", {})):
            ctl = self.cluster.train_controllers.get(name)
            if ctl is None:
                continue
            try:
                jobs.append(ctl.status())
            except Exception:  # noqa: BLE001 — one wedged gang must not 500 the API
                jobs.append({"name": name, "error": "status unavailable"})
        return {
            "jobs": jobs,
            "totals": {
                "steps": metric_defs.TRAIN_STEPS.get(),
                "resizes_scale_up": metric_defs.TRAIN_GANG_RESIZES.get({"reason": "scale_up"}),
                "resizes_scale_down": metric_defs.TRAIN_GANG_RESIZES.get({"reason": "scale_down"}),
                "resizes_preempt": metric_defs.TRAIN_GANG_RESIZES.get({"reason": "preempt"}),
                "repairs_repaired": metric_defs.TRAIN_REPAIRS.get({"outcome": "repaired"}),
                "repairs_shrunk": metric_defs.TRAIN_REPAIRS.get({"outcome": "shrunk"}),
                "repairs_failed": metric_defs.TRAIN_REPAIRS.get({"outcome": "failed"}),
            },
        }

    def _memory_summary(self) -> dict:
        """`ray memory` role for the browser: per-node object totals broken
        down by storage tier, the largest live objects, and native shm-arena
        occupancy where a node has one."""
        from ray_tpu_torch import state as state_api

        objects = state_api.list_objects(limit=100_000)
        nodes: dict = {}
        for o in objects:
            n = nodes.setdefault(
                o["node_id"], {"count": 0, "bytes": 0, "tiers": {}}
            )
            n["count"] += 1
            n["bytes"] += o["size_bytes"] or 0
            tier = o["tier"] or "?"
            t = n["tiers"].setdefault(tier, {"count": 0, "bytes": 0})
            t["count"] += 1
            t["bytes"] += o["size_bytes"] or 0
        # polled every 2 s by the UI: top-k, not a full sort of 100k objects
        import heapq

        top = heapq.nlargest(15, objects, key=lambda o: o["size_bytes"] or 0)
        arenas = {}
        # snapshot: agents register concurrently with this request path
        for nid, node in list(self.cluster.nodes.items()):
            # remote agents piggyback their arena occupancy on resource
            # reports (the arena lives in the agent process); in-proc nodes
            # share the cluster's own arena (Cluster.shm_store -> ObjectStore._shm)
            stats = getattr(node, "arena_stats", None)
            if stats is None:
                shm = getattr(getattr(node, "store", None), "_shm", None)
                if shm is not None:
                    try:
                        stats = {
                            "used": shm.used_bytes,
                            "capacity": shm.capacity,
                            "objects": shm.num_objects,
                        }
                    except OSError:
                        stats = None
            if stats is not None:
                arenas[nid.hex()] = stats
        return {"nodes": nodes, "top_objects": top, "arenas": arenas}

    def _actor_detail(self, prefix: str) -> dict:
        """Per-actor drill-down: FSM state + every task event of its method
        calls.  TaskIDs embed the ActorID as their binary SUFFIX (lineage
        ids), so the join is a plain hex endswith — no per-event object
        construction on this polled path."""
        info = None
        for a in self.cluster.control.actors.list_actors():
            if a.actor_id.hex().startswith(prefix):
                info = a
                break
        if info is None:
            return {"error": f"no actor with id prefix {prefix!r}"}
        aid = info.actor_id.hex()
        events = [
            e
            for e in self.cluster.control.task_events.list_events(limit=100_000)
            if e.get("task_id", "").endswith(aid)
        ]
        return {
            "actor_id": aid,
            "class_name": info.class_name,
            "name": info.name,
            "state": info.state.name,
            "node_id": info.node_id.hex() if info.node_id else None,
            "restarts": info.num_restarts,
            "max_restarts": info.max_restarts,
            "death_cause": info.death_cause,
            "job_id": info.job_id.hex(),
            "events": events[-200:],
        }

    def _task_detail(self, prefix: str) -> dict:
        """Per-task drill-down: all recorded attempts/states + timings."""
        events = [
            e
            for e in self.cluster.control.task_events.list_events(limit=100_000)
            if e.get("task_id", "").startswith(prefix)
        ]
        if not events:
            return {"error": f"no task events for id prefix {prefix!r}"}
        latest = events[-1]
        detail = dict(latest)
        if latest.get("start_ts") and latest.get("ts"):
            detail["duration_s"] = round(latest["ts"] - latest["start_ts"], 6)
        if latest.get("submit_ts") and latest.get("start_ts"):
            detail["queue_wait_s"] = round(latest["start_ts"] - latest["submit_ts"], 6)
        if latest.get("submit_ts") and latest.get("ts"):
            # submit -> terminal (covers agent-executed calls, where the
            # remote start timestamp isn't recorded head-side)
            detail["total_s"] = round(latest["ts"] - latest["submit_ts"], 6)
        detail["events"] = events
        return detail

    def _cluster_status(self) -> dict:
        total: dict = {}
        available: dict = {}
        for node in self.cluster.nodes.values():
            if node.dead:
                continue
            for k, v in node.pool.total.to_dict().items():
                total[k] = total.get(k, 0) + v
            for k, v in node.pool.available.to_dict().items():
                available[k] = available.get(k, 0) + v
        return {
            "resources_total": total,
            "resources_available": available,
            "num_nodes": sum(1 for n in self.cluster.nodes.values() if not n.dead),
            "pending_tasks": self.cluster.task_manager.num_pending(),
        }
