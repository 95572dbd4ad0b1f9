"""Command-line interface.

Parity with ``python/ray/scripts/scripts.py``: ``start`` :568, ``stop``
:1044, ``status``, ``submit``/job commands :1578, ``timeline``,
``microbenchmark`` :1862, plus the state-API ``list``/``summary`` CLI from
``python/ray/util/state``.  Implemented with argparse (no click dependency);
remote commands talk HTTP to a running head's dashboard.

Run as ``python -m ray_tpu_torch <cmd>`` or ``python -m ray_tpu_torch.scripts.cli <cmd>``.

The port's own copy of the JAX package's CLI: the same subcommands and
options (``start --address`` also takes ``--num-gpus``).  The head keeps its
own address file, so the two packages' heads on one machine never see (or
stop) each other.  ``start --head`` opens the multi-host head service,
``start --address`` runs a node agent in this process, and ``up`` starts a
head in this process and provisions the config's node agents through its
provider (``autoscaler/launcher.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time
import urllib.request

ADDRESS_FILE = os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "ray_current_head.json")
#: the port's own address variable (the JAX package reads ``RAY_TPU_ADDRESS``)
ADDRESS_ENV = "RAY_TPU_TORCH_ADDRESS"


def _write_address_file(info: dict) -> None:
    os.makedirs(os.path.dirname(ADDRESS_FILE), exist_ok=True)
    with open(ADDRESS_FILE, "w") as f:
        json.dump(info, f)


def _read_address(explicit: str | None) -> str:
    if explicit:
        return explicit.rstrip("/")
    env = os.environ.get(ADDRESS_ENV)
    if env:
        return env.rstrip("/")
    try:
        with open(ADDRESS_FILE) as f:
            return json.load(f)["dashboard_url"]
    except (OSError, KeyError, json.JSONDecodeError):
        raise SystemExit(
            f"No running head found. Pass --address, set {ADDRESS_ENV}, or run `ray_tpu_torch start` first."
        )


def _get(address: str, path: str):
    with urllib.request.urlopen(address + path, timeout=30) as resp:
        return json.loads(resp.read())


# ----------------------------------------------------------------------
def cmd_start(args) -> int:
    import ray_tpu_torch as rt

    if getattr(args, "address", None):
        # agent mode: join an existing head as a worker node
        # (``ray start --address`` parity, python/ray/scripts/scripts.py:568)
        from ray_tpu_torch.runtime.agent import main as agent_main

        agent_args = ["--address", args.address, "--resources", args.resources, "--labels", args.labels]
        if args.num_cpus is not None:
            agent_args += ["--num-cpus", str(args.num_cpus)]
        if args.num_gpus is not None:
            agent_args += ["--num-gpus", str(args.num_gpus)]
        if args.num_tpus is not None:
            agent_args += ["--num-tpus", str(args.num_tpus)]
        return agent_main(agent_args)

    rt.init(
        num_cpus=args.num_cpus,
        num_gpus=args.num_gpus,
        num_tpus=args.num_tpus,
        include_dashboard=True,
        dashboard_port=args.dashboard_port,
    )
    cluster = rt.get_cluster()
    info = {
        "dashboard_url": cluster.dashboard.url,
        "pid": os.getpid(),
        "session_dir": cluster.session_dir,
    }
    if getattr(args, "head", False):
        bound = cluster.start_head_service(host="0.0.0.0", port=args.port)
        # advertise a routable IP, not the 0.0.0.0 bind address (copying the
        # printed join command to another machine must just work)
        from ray_tpu_torch.util.misc import get_node_ip_address

        info["node_address"] = f"{get_node_ip_address()}:{bound.rsplit(':', 1)[1]}"
    _write_address_file(info)
    # flushed: a head in the background writes to a pipe or a file, and
    # whoever started it reads the join address from these lines
    print(f"ray_tpu_torch head started. Dashboard: {cluster.dashboard.url}", flush=True)
    if "node_address" in info:
        print(f"Join more nodes with: python -m ray_tpu_torch start --address {info['node_address']}",
              flush=True)
    print(f"Submit jobs with: python -m ray_tpu_torch job submit --address {cluster.dashboard.url} -- <cmd>",
          flush=True)

    # `rt stop` sends SIGTERM (SIGINT is ignored by shells' background jobs).
    stop_requested = {"flag": False}

    def _on_term(signum, frame):
        stop_requested["flag"] = True

    signal.signal(signal.SIGTERM, _on_term)
    try:
        while not stop_requested["flag"]:
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        rt.shutdown()
    return 0


def cmd_up(args) -> int:
    """`ray up` parity: head + provisioned workers from a YAML config."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler.launcher import up

    launcher = up(args.config, wait_for_min_workers=not args.no_wait)
    cluster = rt.get_cluster()
    live = sum(1 for n in cluster.nodes.values() if not n.dead)
    print(f"cluster up: control plane at {launcher.address}, {live} nodes")
    print(f"Join more nodes with: python -m ray_tpu_torch start --address {launcher.address}")

    stop_requested = {"flag": False}

    def _on_term(signum, frame):
        stop_requested["flag"] = True

    signal.signal(signal.SIGTERM, _on_term)
    try:
        while not stop_requested["flag"]:
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        launcher.down()
        rt.shutdown()
    return 0


def _pid_is_head(pid: int) -> bool:
    """Guard against pid reuse: only signal a process that is actually a
    ray_tpu_torch head (checked via /proc cmdline; best-effort elsewhere).
    The check matches the port's module names as whole arguments, so the
    JAX package's head (``-m ray_tpu``) is never taken for the port's."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            argv = f.read().decode(errors="replace").split("\x00")
        return any(a in HEAD_MODULES for a in argv)
    except FileNotFoundError:
        return False
    except OSError:
        # no /proc (non-Linux): fall back to existence only
        try:
            os.kill(pid, 0)
            return True
        except (ProcessLookupError, PermissionError):
            return False


def _exited(pid: int) -> bool:
    """True once ``pid`` is gone or a zombie: a head that exited but whose
    parent has not reaped it yet still answers ``kill(pid, 0)``, and the
    JAX package's ``stop`` waits its whole 10 s on it."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except (OSError, IndexError):
        return False


#: the command lines a head started by this CLI runs under
HEAD_MODULES = ("ray_tpu_torch", "ray_tpu_torch.__main__", "ray_tpu_torch.scripts.cli")


def cmd_stop(args) -> int:
    try:
        with open(ADDRESS_FILE) as f:
            info = json.load(f)
    except OSError:
        print("no head address file; nothing to stop")
        return 0
    pid = info.get("pid")
    if pid and not _pid_is_head(pid):
        # stale address file: the pid died and may have been recycled by an
        # unrelated process — never signal it
        print(f"head pid {pid} is gone (stale address file)")
    elif pid:
        try:
            os.kill(pid, signal.SIGTERM)
            print(f"sent SIGTERM to head pid {pid}")
            for _ in range(40):
                time.sleep(0.25)
                if _exited(pid):
                    break
            else:
                if _pid_is_head(pid):
                    os.kill(pid, signal.SIGKILL)
                    print(f"head pid {pid} did not exit; killed")
        except (ProcessLookupError, PermissionError):
            print(f"head pid {pid} already gone")
    try:
        os.unlink(ADDRESS_FILE)
    except OSError:
        pass
    return 0


def cmd_status(args) -> int:
    address = _read_address(args.address)
    status = _get(address, "/api/cluster_status")
    nodes = _get(address, "/api/nodes")["nodes"]
    print(f"Nodes: {status['num_nodes']}  Pending tasks: {status['pending_tasks']}")
    print("Resources:")
    for k, total in sorted(status["resources_total"].items()):
        avail = status["resources_available"].get(k, 0)
        print(f"  {total - avail:g}/{total:g} {k} used")
    for n in nodes:
        head = " (head)" if n["is_head"] else ""
        print(f"  node {n['node_id'][:12]} {n['state']}{head}")
    return 0


def cmd_list(args) -> int:
    address = _read_address(args.address)
    route = {"pgs": "placement_groups"}.get(args.kind, args.kind)
    data = _get(address, f"/api/{route}?limit={args.limit}")
    rows = data[route]
    print(json.dumps(rows, indent=2, default=str) if args.format == "json" else _table(rows))
    return 0


def cmd_summary(args) -> int:
    address = _read_address(args.address)
    print(json.dumps(_get(address, f"/api/summary/{args.kind}"), indent=2))
    return 0


def cmd_timeline(args) -> int:
    address = _read_address(args.address)
    route = "/api/timeline?tracing=1" if getattr(args, "tracing", False) else "/api/timeline"
    trace = _get(address, route)
    with open(args.output, "w") as f:
        json.dump(trace, f)
    print(f"wrote {len(trace)} events to {args.output} (open in chrome://tracing or Perfetto)")
    return 0


def cmd_metrics(args) -> int:
    address = _read_address(args.address)
    with urllib.request.urlopen(address + "/metrics", timeout=30) as resp:
        sys.stdout.write(resp.read().decode())
    return 0


# ----------------------------------------------------------------------
def cmd_job(args) -> int:
    from ray_tpu_torch.job.sdk import JobSubmissionClient

    client = JobSubmissionClient(_read_address(args.address))
    if args.job_cmd == "submit":
        import shlex

        # re-quote argv words so the shell sees the original tokens
        entrypoint = shlex.join(args.entrypoint)
        runtime_env = json.loads(args.runtime_env_json) if args.runtime_env_json else None
        sub_id = client.submit_job(entrypoint=entrypoint, runtime_env=runtime_env)
        print(f"submitted: {sub_id}")
        if not args.no_wait:
            info = client.wait_until_finished(sub_id, timeout=args.timeout)
            print(f"status: {info['status']} ({info['message']})")
            print(client.get_job_logs(sub_id), end="")
            return 0 if info["status"] == "SUCCEEDED" else 1
    elif args.job_cmd == "status":
        print(client.get_job_status(args.submission_id))
    elif args.job_cmd == "logs":
        print(client.get_job_logs(args.submission_id), end="")
    elif args.job_cmd == "stop":
        print("stopped" if client.stop_job(args.submission_id) else "not found")
    elif args.job_cmd == "list":
        print(_table(client.list_jobs()))
    return 0


def cmd_stack(args) -> int:
    """Cluster-wide live stack dump (reference: `ray stack`,
    scripts.py:1830 — py-spy per worker; here every process answers over
    its control channel, so a wedged exec thread still reports)."""
    address = _read_address(args.address)
    data = _get(address, f"/api/stack?timeout={args.timeout}")
    print("===== driver =====")
    print(data.get("driver", ""))
    for node_hex, entry in sorted(data.get("nodes", {}).items()):
        if entry.get("error"):
            print(f"===== node {node_hex[:12]} =====\n{entry['error']}")
            continue
        if entry.get("process"):
            print(f"===== node {node_hex[:12]} agent =====")
            print(entry["process"])
        for pid, stacks in sorted(entry.get("workers", {}).items()):
            print(f"===== node {node_hex[:12]} worker pid {pid} =====")
            print(stacks)
    return 0


def cmd_memory(args) -> int:
    """``rt memory`` (parity: ray memory): `rt list objects` plus a totals
    footer — delegates to the shared list path."""
    args.kind = "objects"
    args.format = "table"
    cmd_list(args)
    data = _get(_read_address(args.address), f"/api/objects?limit={args.limit}")
    rows = data["objects"]
    total = sum(r.get("size_bytes") or 0 for r in rows)
    print(f"{len(rows)} objects, {total / 1e6:.2f} MB total")
    return 0


def cmd_serve(args) -> int:
    """``rt serve deploy|run|status|shutdown`` (parity: the serve CLI,
    serve/scripts.py — config-file deploys against a running runtime)."""
    import json as _json

    import ray_tpu_torch

    ray_tpu_torch.init(ignore_reinit_error=True)
    from ray_tpu_torch import serve

    if args.serve_cmd in ("deploy", "run"):
        deployed = serve.run_config(args.config)
        print(_json.dumps({"deployed": deployed}, indent=2))
        if args.serve_cmd == "run":
            import time as _time

            try:
                while True:
                    _time.sleep(1)
            except KeyboardInterrupt:
                serve.shutdown()
        return 0
    if args.serve_cmd == "status":
        print(_json.dumps(serve.status(), indent=2, default=str))
        return 0
    serve.shutdown()
    print("serve shut down")
    return 0


def cmd_pulls(args) -> int:
    """``rt pulls``: PullManager snapshot — queue depth, in-flight bytes,
    dedup hits — plus the scheduler's locality hit/miss byte totals."""
    address = _read_address(args.address)
    data = _get(address, "/api/pulls")
    pm = data.get("pull_manager", {})
    loc = data.get("locality", {})
    if args.format == "json":
        print(json.dumps(data, indent=2))
        return 0
    print(
        f"pulls: {pm.get('inflight', 0)} in flight "
        f"({pm.get('inflight_bytes', 0) / 1e6:.1f} MB of "
        f"{pm.get('max_inflight_bytes', 0) / 1e6:.0f} MB budget), "
        f"{pm.get('queued', 0)} queued for admission"
    )
    print(
        f"lifetime: {pm.get('completed', 0)} completed, "
        f"{pm.get('bytes_pulled', 0) / 1e6:.1f} MB moved, "
        f"{pm.get('dedup_hits', 0)} dedup hits, {pm.get('retries', 0)} retries"
    )
    bc = data.get("broadcast", {})
    active = bc.get("active", [])
    print(
        f"broadcast: {len(active)} active plans, "
        f"{bc.get('plans_total', 0)} lifetime, "
        f"{bc.get('relay_bytes', 0) / 1e6:.1f} MB relayed off-root"
    )
    for plan in active:
        print(
            f"  plan {plan['oid']}: {plan['done']}/{plan['dests']} dests done "
            f"(fanout {plan['fanout']}, {plan['parked']} parked, "
            f"root {plan['root'] or '?'})"
        )
    fc = data.get("frame_cache")
    if fc is not None:
        total = fc.get("hits", 0) + fc.get("misses", 0)
        pct = f" ({100 * fc['hits'] / total:.0f}% hit)" if total else ""
        print(f"frame cache: {fc.get('hits', 0)} hits, {fc.get('misses', 0)} misses{pct}")
    hit, miss = loc.get("hit_bytes", 0), loc.get("miss_bytes", 0)
    total = hit + miss
    pct = f" ({100 * hit / total:.0f}% local)" if total else ""
    print(
        f"locality: {hit / 1e6:.1f} MB scheduled onto their bytes, "
        f"{miss / 1e6:.1f} MB needed transfer{pct}"
    )
    return 0


def cmd_leases(args) -> int:
    """``rt leases``: worker-lease snapshot — per-shape cached dispatch
    routes, grant/reuse/spillback lifetime churn, the direct-push transport
    split, and actor direct-route totals."""
    address = _read_address(args.address)
    data = _get(address, "/api/leases")
    if args.format == "json":
        print(json.dumps(data, indent=2))
        return 0
    leases = data.get("leases", {})
    head = data.get("head", {})
    pushes = data.get("pushes", {})
    actors = data.get("actor_routes", {})
    active = leases.get("active", [])
    print(
        f"leases: {len(active)} active; lifetime {leases.get('grants', 0)} grants, "
        f"{leases.get('reuse_hits', 0)} reuse hits, "
        f"{leases.get('spillbacks', 0)} spillbacks, "
        f"{leases.get('expired', 0)} expired, {leases.get('revoked', 0)} revoked"
    )
    for lease in active:
        res = " ".join(f"{k}={v:g}" for k, v in sorted(lease.get("resources", {}).items()))
        print(
            f"  {lease['function']}() [{lease['execution']}] -> node {lease['node']}  "
            f"{lease['uses']} uses, idle {lease['idle_s']:.1f}s  ({res})"
        )
    print(
        f"direct pushes: {pushes.get('inproc', 0):.0f} inproc, "
        f"{pushes.get('data_plane', 0):.0f} data-plane, "
        f"{pushes.get('actor_direct', 0):.0f} actor-direct"
    )
    print(
        f"actor routes: {actors.get('active_routes', 0)} active, "
        f"{actors.get('direct_submits', 0)} calls routed direct"
    )
    print(
        f"head: {head.get('scheduling_decisions', 0)} scheduling decisions made, "
        f"{head.get('rpcs_avoided', 0):.0f} per-task hops avoided"
    )
    return 0


def cmd_plans(args) -> int:
    """``rt plans``: installed compiled execution plans — per-plan state,
    stage placement, iteration counts, plus the process-wide channel
    traffic/occupancy totals."""
    address = _read_address(args.address)
    data = _get(address, "/api/plans")
    if args.format == "json":
        print(json.dumps(data, indent=2))
        return 0
    totals = data.get("totals", {})
    plans = data.get("plans", [])
    print(
        f"plans: {len(plans)} installed, "
        f"{totals.get('executions_ok', 0):.0f} iterations ok / "
        f"{totals.get('executions_error', 0):.0f} failed, "
        f"{totals.get('channel_bytes_sent', 0) / 1e6:.1f} MB pushed on channel "
        f"streams ({totals.get('channel_occupancy', 0):.0f} slots occupied)"
    )
    print(
        f"device channels: "
        f"{totals.get('device_channel_bytes_sent', 0) / 1e6:.1f} MB sent / "
        f"{totals.get('device_channel_bytes_received', 0) / 1e6:.1f} MB received "
        f"pickle-free, {totals.get('hbm_resident_bytes', 0) / 1e6:.1f} MB "
        f"HBM-resident in {totals.get('device_channel_occupancy', 0):.0f} device "
        f"slots, {totals.get('stage_group_executions', 0):.0f} gang iterations"
    )
    for plan in plans:
        print(
            f"  plan {plan['plan']} [{plan['name']}] {plan['state']}: "
            f"{plan['executions']} executed, {plan['failed']} failed, "
            f"{plan['inflight']} in flight"
        )
        for stage in plan.get("stages", ()):
            gang = f" gang={stage['group']}" if stage.get("group") else ""
            print(
                f"    s{stage['stage']} {stage['method']}() "
                f"actor {stage['actor']} on node {stage['node']} ({stage['proc']})"
                f"{gang}"
            )
        kinds = plan.get("channel_kinds") or {}
        for name in plan.get("channels", ()):
            print(f"    edge {name}: {kinds.get(name, 'pickle')}")
        if plan.get("error"):
            print(f"    error: {plan['error']}")
    return 0


def cmd_train(args) -> int:
    """``rt train``: registered training gangs — size, step, last
    checkpoint, resize/repair history, and the process-wide step /
    resize / repair counters."""
    address = _read_address(args.address)
    data = _get(address, "/api/train")
    if args.format == "json":
        print(json.dumps(data, indent=2))
        return 0
    totals = data.get("totals", {})
    jobs = data.get("jobs", [])
    print(
        f"train: {len(jobs)} gang(s), {totals.get('steps', 0):.0f} steps, "
        f"resizes {totals.get('resizes_scale_up', 0):.0f} up / "
        f"{totals.get('resizes_scale_down', 0):.0f} down / "
        f"{totals.get('resizes_preempt', 0):.0f} preempt, "
        f"repairs {totals.get('repairs_repaired', 0):.0f} repaired / "
        f"{totals.get('repairs_shrunk', 0):.0f} shrunk / "
        f"{totals.get('repairs_failed', 0):.0f} failed"
    )
    for job in jobs:
        if job.get("error"):
            print(f"  job {job['name']}: {job['error']}")
            continue
        loss = job.get("last_loss")
        loss_s = f"{loss:.4f}" if loss is not None else "-"
        print(
            f"  job {job['name']} [{job.get('plan_state')}]: "
            f"gang {job['gang_size']}, step {job['step']}, loss {loss_s}, "
            f"ckpt {job.get('last_checkpoint') or '-'}"
        )
        for r in job.get("resizes", ()):
            print(
                f"    resize @step {r['step']}: {r['from']} -> {r['to']} "
                f"({r['reason']})"
            )
        for r in job.get("repairs", ()):
            print(
                f"    repair @step {r['step']}: {r['outcome']} "
                f"(gang {r.get('world_size', '?')}, {r.get('error') or 'no error'})"
            )
    return 0


def cmd_nodes(args) -> int:
    """``rt nodes``: per-node lifecycle state (ALIVE / DRAINING / DEAD),
    drain history with evacuation totals, head restarts, and the autoscaler
    summary when one is running."""
    address = _read_address(args.address)
    data = _get(address, "/api/autoscaler")
    if args.format == "json":
        print(json.dumps(data, indent=2))
        return 0
    for n in data.get("nodes", ()):
        head = " (head)" if n.get("is_head") else ""
        res = " ".join(f"{k}={v:g}" for k, v in sorted(n.get("resources", {}).items()))
        inc = n.get("incarnation") or 0
        inc_s = f"  inc={inc}" if inc else ""
        print(f"  node {n['node_id'][:12]} {n['state']:9s}{head}  {res}{inc_s}")
    if data.get("fenced_frames"):
        kinds = ", ".join(
            f"{k}={v}" for k, v in sorted(data.get("fenced_by_kind", {}).items())
        )
        print(f"fenced frames: {data['fenced_frames']} ({kinds})")
    wd = data.get("watchdog") or {}
    if wd.get("deadlines_fired") or wd.get("hedges_launched"):
        print(
            f"watchdog: {wd.get('deadlines_fired', 0)} deadlines fired, "
            f"{wd.get('hedges_launched', 0)} hedges "
            f"({wd.get('hedges_won', 0)} won / {wd.get('hedges_lost', 0)} lost, "
            f"{wd.get('hedge_discards', 0)} stale commits discarded)"
        )
    drains = data.get("drains", ())
    if drains:
        evac = sum(d.get("evacuated", 0) for d in drains)
        mb = sum(d.get("evacuated_bytes", 0) for d in drains) / 1e6
        outcomes = {}
        for d in drains:
            outcomes[d.get("outcome", "?")] = outcomes.get(d.get("outcome", "?"), 0) + 1
        summary = ", ".join(f"{n} {o}" for o, n in sorted(outcomes.items()))
        print(f"drains: {len(drains)} ({summary}); {evac} objects / {mb:.1f} MB evacuated")
    print(f"head restarts: {data.get('head_restarts', 0)}")
    autoscaler = data.get("autoscaler")
    if autoscaler:
        active = ", ".join(
            f"{n} x {t}" for t, n in sorted(autoscaler.get("active_nodes", {}).items())
        ) or "none"
        print(
            f"autoscaler: {active} managed; {autoscaler.get('num_launches', 0)} "
            f"launches, {autoscaler.get('num_terminations', 0)} terminations, "
            f"{len(autoscaler.get('pending_demands', []))} pending demands"
        )
    return 0


def cmd_overload(args) -> int:
    """``rt overload``: the admission-control spine at a glance — per-layer
    bounds vs current depths, lifetime shed totals by (layer, reason), the
    per-caller submission gate, and store put-backpressure counters."""
    address = _read_address(args.address)
    data = _get(address, "/api/overload")
    if args.format == "json":
        print(json.dumps(data, indent=2))
        return 0
    totals = data.get("shed_totals", {})
    total_shed = sum(n for reasons in totals.values() for n in reasons.values())
    print(f"sheds: {total_shed} lifetime ({data.get('events_total', 0)} audited)")
    for layer in sorted(totals):
        reasons = ", ".join(f"{r}={n}" for r, n in sorted(totals[layer].items()))
        print(f"  {layer}: {reasons}")
    dq = data.get("demand_queue", {})
    print(f"demand queue: {dq.get('depth', 0)} parked (bound {dq.get('bound', 0)})")
    gate = data.get("submission")
    if gate and gate.get("cap", 0) > 0:
        print(
            f"submission gate: {gate['inflight']} in flight over "
            f"{gate['callers']} caller(s), cap {gate['cap']}/caller "
            f"[{gate['policy']}], {gate['blocks']} blocks, {gate['sheds']} sheds"
        )
    store = data.get("store", {})
    if store.get("disk_budget"):
        print(
            f"store: host {store.get('host_used', 0) / 1e6:.1f}/"
            f"{store.get('host_budget', 0) / 1e6:.0f} MB, disk "
            f"{store.get('disk_used', 0) / 1e6:.1f}/"
            f"{store.get('disk_budget', 0) / 1e6:.0f} MB, "
            f"{store.get('put_backpressure_waits', 0)} backpressured puts, "
            f"{store.get('puts_shed', 0)} shed"
        )
    for src in data.get("sources", ()):
        if src.get("layer") == "engine":
            print(
                f"llm engine: {src.get('queued', 0)} queued "
                f"(bound {src.get('queue_bound', 0)}), "
                f"{src.get('queued_prefill_tokens', 0)} prefill tokens "
                f"(budget {src.get('token_budget', 0) or 'unbounded'}), "
                f"{src.get('active_slots', 0)}/{src.get('slots', 0)} slots, "
                f"{src.get('slots_evicted', 0)} evicted, {src.get('shed', 0)} shed"
            )
            if src.get("kv_block_pool_size"):
                print(
                    f"  kv blocks: {src.get('kv_blocks_in_use', 0)}/"
                    f"{src.get('kv_block_pool_size', 0)} in use "
                    f"({100.0 * src.get('kv_block_occupancy', 0.0):.0f}%), "
                    f"block size {src.get('kv_block_size', 0)}, "
                    f"{src.get('prefilling', 0)} prefilling, "
                    f"{src.get('prefill_chunks', 0)} chunks, "
                    f"{src.get('waiting_for_blocks', 0)} waiting for blocks"
                )
            if src.get("prefix_cache_enabled"):
                print(
                    f"  prefix cache: {src.get('prefix_cache_blocks', 0)} blocks, "
                    f"{100.0 * src.get('prefix_hit_rate', 0.0):.0f}% hit rate, "
                    f"{src.get('kv_blocks_shared', 0)} shared, "
                    f"{src.get('prefix_tokens_reused', 0)} tokens reused, "
                    f"{src.get('prefix_evictions', 0)} evictions"
                )
            lat = src.get("latency", {})
            ttft, itl = lat.get("ttft", {}), lat.get("inter_token", {})
            if ttft.get("count"):
                print(
                    f"  latency: ttft p99={ttft['p99'] * 1000:.1f}ms, "
                    f"inter-token p99={itl.get('p99', 0.0) * 1000:.1f}ms"
                )
    for dep, pools in sorted(data.get("serve_pools", {}).items()):
        for role, row in sorted(pools.items()):
            extra = (
                f", {100.0 * row['kv_free_frac']:.0f}% kv free"
                if "kv_free_frac" in row else ""
            )
            print(
                f"pool {dep}/{role}: {row.get('replicas', 0)}/"
                f"{row.get('target', 0)} replicas, "
                f"{row.get('ongoing', 0)} ongoing{extra}"
            )
    for dep, sketches in sorted(data.get("request_latency", {}).items()):
        e2e = sketches.get("e2e", {})
        if e2e.get("count"):
            print(
                f"deployment {dep or '-'}: e2e p50={e2e['p50'] * 1000:.1f}ms "
                f"p95={e2e['p95'] * 1000:.1f}ms p99={e2e['p99'] * 1000:.1f}ms "
                f"over {e2e['count']} request(s)"
            )
    return 0


def cmd_llm(args) -> int:
    """``rt llm``: LLM serving engines at a glance — cache kind, KV block
    pool occupancy, chunked-prefill progress, queue/slot pressure. One line
    block per registered engine (admission source layer == "engine")."""
    address = _read_address(args.address)
    data = _get(address, "/api/overload")
    engines = [s for s in data.get("sources", ()) if s.get("layer") == "engine"]
    if args.format == "json":
        print(json.dumps(engines, indent=2))
        return 0
    if not engines:
        print("no llm engines registered")
        return 0
    for i, src in enumerate(engines):
        kind = src.get("cache_kind", "dense")
        role = src.get("role") or ""
        role_txt = f" role={role}," if role else ""
        print(
            f"engine {i}: cache={kind},{role_txt} "
            f"{src.get('active_slots', 0)}/{src.get('slots', 0)} slots, "
            f"{src.get('queued', 0)} queued (bound {src.get('queue_bound', 0)}), "
            f"{src.get('shed', 0)} shed, {src.get('slots_evicted', 0)} evicted"
        )
        if role or src.get("migrations_out") or src.get("migrations_in"):
            print(
                f"  migrations: {src.get('migrations_out', 0)} out, "
                f"{src.get('migrations_in', 0)} in, "
                f"{src.get('staged_migrations', 0)} staged"
            )
        if kind == "paged":
            print(
                f"  kv pool: {src.get('kv_blocks_in_use', 0)}/"
                f"{src.get('kv_block_pool_size', 0)} blocks in use "
                f"({100.0 * src.get('kv_block_occupancy', 0.0):.0f}%), "
                f"block size {src.get('kv_block_size', 0)} tokens"
            )
            print(
                f"  prefill: {src.get('prefilling', 0)} in flight, "
                f"{src.get('prefill_chunks', 0)} chunks total, "
                f"{src.get('waiting_for_blocks', 0)} head-of-line waiting for blocks"
            )
            if src.get("prefix_cache_enabled"):
                print(
                    f"  prefix cache: {src.get('prefix_cache_blocks', 0)} blocks "
                    f"cached, {100.0 * src.get('prefix_hit_rate', 0.0):.0f}% hit "
                    f"rate, {src.get('kv_blocks_shared', 0)} pages shared, "
                    f"{src.get('prefix_tokens_reused', 0)} prompt tokens reused, "
                    f"{src.get('prefix_evictions', 0)} evictions"
                )
            else:
                print("  prefix cache: off")
        lat = src.get("latency", {})
        parts = []
        for name in ("ttft", "inter_token", "queue_wait", "e2e"):
            pct = lat.get(name, {})
            if pct.get("count"):
                parts.append(
                    f"{name} p50={pct['p50'] * 1000:.1f}ms "
                    f"p99={pct['p99'] * 1000:.1f}ms"
                )
        if parts:
            print("  latency: " + "; ".join(parts))
    for dep, pools in sorted(data.get("serve_pools", {}).items()):
        for role, row in sorted(pools.items()):
            extra = (
                f", {100.0 * row['kv_free_frac']:.0f}% kv free"
                if "kv_free_frac" in row else ""
            )
            print(
                f"pool {dep}/{role}: {row.get('replicas', 0)}/"
                f"{row.get('target', 0)} replicas, "
                f"{row.get('ongoing', 0)} ongoing{extra}"
            )
    return 0


def _print_waterfall(tr: dict, width: int = 36) -> None:
    """One trace as an aligned phase waterfall. Phases are deltas between
    consecutive lifecycle marks, so the bars sum exactly to e2e."""
    e2e = tr.get("e2e_s") or 0.0
    ttft = tr.get("ttft_s")
    ttft_txt = f" ttft={ttft * 1000:.1f}ms" if ttft is not None else ""
    print(
        f"  {tr.get('id', '?')} [{tr.get('deployment') or tr.get('route') or '-'}] "
        f"{tr.get('outcome', '?')} e2e={e2e * 1000:.1f}ms{ttft_txt} "
        f"tokens={tr.get('tokens', 0)}"
    )
    if not e2e:
        return
    for ph in tr.get("phases", ()):
        start, dur = ph.get("start_s", 0.0), ph.get("dur_s", 0.0)
        lead = min(int(round(start / e2e * width)), width - 1)
        bar = min(max(1, int(round(dur / e2e * width))), width - lead)
        print(
            f"    {ph.get('phase', '?'):<14}|{' ' * lead}{'#' * bar}"
            f"{' ' * (width - lead - bar)}| {dur * 1000:9.2f}ms"
        )


def cmd_requests(args) -> int:
    """``rt requests``: request-scope lifecycle traces as phase waterfalls
    (proxy -> router queue -> dispatch -> engine queue -> kv-block wait ->
    prefill -> decode), the slowest-N / in-flight views, and per-deployment
    SLO percentiles from the trace store's latency sketches."""
    address = _read_address(args.address)
    data = _get(address, f"/api/requests?limit={args.limit}")
    if args.format == "json":
        print(json.dumps(data, indent=2))
        return 0
    label = "slowest" if args.slowest else "recent"
    traces = data.get(label, [])
    inflight = data.get("in_flight", [])
    if not traces and not inflight:
        print(
            "no request traces recorded "
            "(serve_request_trace off, or no traffic yet)"
        )
        return 0
    print(f"{len(traces)} {label} trace(s), {len(inflight)} in flight")
    for tr in traces[: args.limit]:
        _print_waterfall(tr)
    for tr in inflight[: args.limit]:
        _print_waterfall(tr)
    deps = data.get("deployments", {})
    for dep in sorted(deps):
        for name, pct in sorted(deps[dep].items()):
            if pct.get("count"):
                print(
                    f"{dep or '-'}/{name}: n={pct['count']} "
                    f"p50={pct['p50'] * 1000:.1f}ms "
                    f"p95={pct['p95'] * 1000:.1f}ms "
                    f"p99={pct['p99'] * 1000:.1f}ms"
                )
    return 0


def cmd_chaos(args) -> int:
    if args.chaos_cmd == "validate":
        from ray_tpu_torch.chaos.schedule import validate_cli

        return validate_cli(args)
    from ray_tpu_torch.chaos.runner import run_cli

    return run_cli(args)


def cmd_lint(args) -> int:
    """AST invariant linter (``rt lint``): enforce the runtime's
    concurrency, wire-protocol, determinism, and observability contracts.
    See docs/static_analysis.md for the checker catalog."""
    from ray_tpu_torch.analysis import all_checkers, run_lint
    from ray_tpu_torch.analysis.framework import render_json, repo_root_dir

    known = {c.check_id for c in all_checkers()}
    checks = set(args.check) if args.check else None
    if checks and not checks <= known:
        print(f"unknown check(s): {', '.join(sorted(checks - known))}; "
              f"known: {', '.join(sorted(known))}", file=sys.stderr)
        return 2
    if args.update_protocol_manifest:
        from ray_tpu_torch.analysis.protocol_parity import update_manifest

        ok, msg = update_manifest(repo_root_dir())
        print(msg, file=sys.stdout if ok else sys.stderr)
        return 0 if ok else 1
    violations = run_lint(paths=args.paths or None, checks=checks)
    if args.json:
        print(render_json(violations))
    else:
        for v in violations:
            print(v.render())
        if violations:
            print(f"\n{len(violations)} violation(s)", file=sys.stderr)
    return 1 if violations else 0


def cmd_microbenchmark(args) -> int:
    """Microbenchmark suite (``ray microbenchmark`` parity: the ray_perf.py
    metric set, plus the TPU-native shm / host<->HBM bandwidth axes)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.scripts.microbench import BASELINES, run_suite

    rt.init(num_cpus=args.num_cpus)

    def progress(name, value, unit):
        base = BASELINES.get(name)
        vs = f"{value / base[0]:7.2f}x vs ref" if base else ""
        # six significant digits: a p99 in seconds or a ratio near 1 would
        # print as 0.0 or 1.0 at one decimal
        print(f"{name:42s} {value:14.6g} {unit:>8s} {vs}")

    select = args.only.split(",") if args.only else None
    try:
        run_suite(rt, select=select, quick=args.quick, progress=progress)
    finally:
        # a row's failed guard must not leave the runtime up behind it
        rt.shutdown()
    return 0


# ----------------------------------------------------------------------
def _table(rows) -> str:
    if not rows:
        return "(empty)"
    cols = [c for c in rows[0] if not isinstance(rows[0][c], (dict, list))]
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows)) for c in cols}
    out = ["  ".join(c.ljust(widths[c]) for c in cols)]
    out.append("  ".join("-" * widths[c] for c in cols))
    for r in rows:
        out.append("  ".join(str(r.get(c, "")).ljust(widths[c]) for c in cols))
    return "\n".join(out)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ray_tpu_torch", description="distributed compute CLI (the PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser(
        "start",
        help="start a head with dashboard + job server (blocks: the head "
        "lives in this process; run it in the background to detach)",
    )
    sp.add_argument("--num-cpus", type=int, default=None)
    sp.add_argument("--num-gpus", type=int, default=None,
                    help="CUDA devices this node offers (the GPU resource)")
    sp.add_argument("--num-tpus", type=int, default=None)
    sp.add_argument("--dashboard-port", type=int, default=8265)
    sp.add_argument(
        "--head", action="store_true",
        help="also open the TCP control plane so node agents can join",
    )
    sp.add_argument("--port", type=int, default=0, help="control-plane port with --head (0 = auto)")
    sp.add_argument(
        "--address", default=None,
        help="join an existing head as a node agent (host:port) instead of starting one",
    )
    sp.add_argument("--resources", default="{}", help="JSON extra resources (agent mode)")
    sp.add_argument("--labels", default="{}", help="JSON node labels (agent mode)")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("stop", help="stop the running head")
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser(
        "up",
        help="launch a cluster from a YAML config (head here + provisioned "
        "workers; blocks, Ctrl-C/SIGTERM tears the cluster down)",
    )
    sp.add_argument("config", help="cluster YAML (see ray_tpu_torch/autoscaler/launcher.py)")
    sp.add_argument("--no-wait", action="store_true", help="don't wait for min_workers")
    sp.set_defaults(fn=cmd_up)

    sp = sub.add_parser("status", help="cluster resource status")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("list", help="list cluster state")
    sp.add_argument("kind", choices=["nodes", "actors", "tasks", "objects", "jobs", "pgs"])
    sp.add_argument("--address", default=None)
    sp.add_argument("--limit", type=int, default=100)
    sp.add_argument("--format", choices=["table", "json"], default="table")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("summary", help="state summaries")
    sp.add_argument("kind", choices=["tasks", "actors", "objects"])
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_summary)

    sp = sub.add_parser("timeline", help="dump chrome-tracing timeline")
    sp.add_argument("--address", default=None)
    sp.add_argument("-o", "--output", default="timeline.json")
    sp.add_argument(
        "--tracing", action="store_true",
        help="include distributed-tracing spans (submit/schedule/execute/put phases)",
    )
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser("metrics", help="print Prometheus metrics")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_metrics)

    sp = sub.add_parser("job", help="job submission")
    jsub = sp.add_subparsers(dest="job_cmd", required=True)
    j = jsub.add_parser("submit")
    j.add_argument("--address", default=None)
    j.add_argument("--runtime-env-json", default=None)
    j.add_argument("--no-wait", action="store_true")
    j.add_argument("--timeout", type=float, default=600.0)
    j.add_argument("entrypoint", nargs=argparse.REMAINDER, help="-- <shell command>")
    j.set_defaults(fn=cmd_job)
    for name in ("status", "logs", "stop"):
        j = jsub.add_parser(name)
        j.add_argument("--address", default=None)
        j.add_argument("submission_id")
        j.set_defaults(fn=cmd_job)
    j = jsub.add_parser("list")
    j.add_argument("--address", default=None)
    j.set_defaults(fn=cmd_job)

    sp = sub.add_parser("stack", help="live thread stacks from driver, agents, and workers (ray stack parity)")
    sp.add_argument("--address", default=None)
    sp.add_argument("--timeout", type=float, default=5.0)
    sp.set_defaults(fn=cmd_stack)

    sp = sub.add_parser(
        "pulls",
        help="PullManager snapshot: queue depth, in-flight bytes, dedup hits, "
        "locality hit/miss bytes",
    )
    sp.add_argument("--address", default=None)
    sp.add_argument("--format", choices=["table", "json"], default="table")
    sp.set_defaults(fn=cmd_pulls)

    sp = sub.add_parser(
        "leases",
        help="worker leases / direct dispatch: active per-shape leases, "
        "grant/reuse/spillback churn, actor direct routes, head RPCs avoided",
    )
    sp.add_argument("--address", default=None)
    sp.add_argument("--format", choices=["table", "json"], default="table")
    sp.set_defaults(fn=cmd_leases)

    sp = sub.add_parser(
        "plans",
        help="installed compiled execution plans: state, stage placement, "
        "iteration counts, channel traffic",
    )
    sp.add_argument("--address", default=None)
    sp.add_argument("--format", choices=["table", "json"], default="table")
    sp.set_defaults(fn=cmd_plans)

    sp = sub.add_parser(
        "train",
        help="training gangs: size, step, last checkpoint, resize/repair "
        "history, step/resize/repair counters",
    )
    sp.add_argument("--address", default=None)
    sp.add_argument("--format", choices=["table", "json"], default="table")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser(
        "nodes",
        help="node lifecycle states (ALIVE/DRAINING/DEAD), drain/evacuation "
        "history, head restarts, autoscaler summary",
    )
    sp.add_argument("--address", default=None)
    sp.add_argument("--format", choices=["table", "json"], default="table")
    sp.set_defaults(fn=cmd_nodes)

    sp = sub.add_parser(
        "overload",
        help="admission-control snapshot: per-layer bounds vs depths, shed "
        "totals, submission gate, store put backpressure",
    )
    sp.add_argument("--address", default=None)
    sp.add_argument("--format", choices=["table", "json"], default="table")
    sp.set_defaults(fn=cmd_overload)

    sp = sub.add_parser(
        "llm",
        help="LLM serving engines: KV block pool occupancy, chunked-prefill "
        "progress, slot/queue pressure",
    )
    sp.add_argument("--address", default=None)
    sp.add_argument("--format", choices=["table", "json"], default="table")
    sp.set_defaults(fn=cmd_llm)

    sp = sub.add_parser(
        "requests",
        help="request lifecycle traces: per-phase waterfalls (proxy/router/"
        "engine queue/kv wait/prefill/decode), slowest-N, in-flight, "
        "per-deployment SLO percentiles",
    )
    sp.add_argument("--address", default=None)
    sp.add_argument("--limit", type=int, default=8)
    sp.add_argument(
        "--slowest", action="store_true",
        help="show the slowest-N traces instead of the most recent",
    )
    sp.add_argument("--format", choices=["table", "json"], default="table")
    sp.set_defaults(fn=cmd_requests)

    sp = sub.add_parser("memory", help="object store contents + refcounts (ray memory parity)")
    sp.add_argument("--address", default=None)
    sp.add_argument("--limit", type=int, default=1000)
    sp.set_defaults(fn=cmd_memory)

    sp = sub.add_parser("serve", help="serve deploy/status/shutdown")
    ssub = sp.add_subparsers(dest="serve_cmd", required=True)
    s = ssub.add_parser("deploy", help="deploy applications from a YAML config")
    s.add_argument("config", help="path to a serve config YAML")
    s.set_defaults(fn=cmd_serve)
    s = ssub.add_parser("run", help="deploy and block until interrupted")
    s.add_argument("config")
    s.set_defaults(fn=cmd_serve)
    for name in ("status", "shutdown"):
        s = ssub.add_parser(name)
        s.set_defaults(fn=cmd_serve)

    sp = sub.add_parser(
        "chaos",
        help="deterministic fault injection (failpoints + seeded schedules)",
    )
    csub = sp.add_subparsers(dest="chaos_cmd", required=True)
    c = csub.add_parser(
        "run",
        help="run a workload under a chaos schedule and check recovery "
        "invariants; same --seed + schedule reproduces the same faults",
    )
    c.add_argument("--schedule", required=True, help="path to a schedule JSON (ray_tpu_torch/chaos/schedule.py)")
    c.add_argument("--seed", type=int, default=None, help="override the schedule's decision-stream seed")
    c.add_argument("--workload", default="fanout", help="builtin workload: fanout|actor")
    c.add_argument("--num-cpus", type=int, default=4)
    c.add_argument("--timeout", type=float, default=60.0, help="quiescence/join budget seconds")
    c.set_defaults(fn=cmd_chaos)
    c = csub.add_parser(
        "validate",
        help="schema-check a schedule JSON (unknown kinds, bad params, "
        "out-of-range node indices) before a run burns minutes on it",
    )
    c.add_argument("schedule", help="path to a schedule JSON")
    c.add_argument(
        "--nodes", type=int, default=None,
        help="live non-head worker count the run will start with "
        "(enables node-index bounds checking)",
    )
    c.set_defaults(fn=cmd_chaos)

    sp = sub.add_parser(
        "lint",
        help="run the AST invariant linter over the tree (docs/static_analysis.md)",
    )
    sp.add_argument(
        "paths", nargs="*",
        help="files or directories to lint (default: the whole ray_tpu_torch tree; "
        "whole-tree parity checks only run on full-tree runs)",
    )
    sp.add_argument("--json", action="store_true", help="machine-readable output")
    sp.add_argument(
        "--check", action="append", metavar="ID",
        help="run only this checker (repeatable)",
    )
    sp.add_argument(
        "--update-protocol-manifest", action="store_true",
        help="regenerate the wire-protocol kind manifest (requires a "
        "PROTOCOL_VERSION bump when the kind set changed)",
    )
    sp.set_defaults(fn=cmd_lint)

    sp = sub.add_parser("microbenchmark", help="run the local microbenchmark suite")
    sp.add_argument("--num-cpus", type=int, default=4)
    sp.add_argument("--only", default=None, help="comma-separated metric names")
    sp.add_argument("--quick", action="store_true", help="shrunk iteration counts")
    sp.set_defaults(fn=cmd_microbenchmark)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # strip a leading "--" from REMAINDER entrypoints
    if getattr(args, "entrypoint", None) and args.entrypoint and args.entrypoint[0] == "--":
        args.entrypoint = args.entrypoint[1:]
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
