"""The port's chaos fabric (``ray_tpu_torch.chaos``) against the JAX
package's, schedule by schedule.

Each scenario builds one seeded ``ChaosSchedule`` and a workload, and runs
them through ``ChaosRunner`` in one package; the test runs it in the JAX
package and then in the port (each on a fresh one-node runtime, twice where
the JAX test runs it twice) and holds the port to the parity rule: the same
seed gives the same fault log (failpoint names, decision indices and
actions, entry by entry: the log carries no ids), the same kinds of
``events_applied`` and the same invariant ``checked`` counts; both runs of
one package agree with each other too. Outputs go through the runtime
tests' ``_norm`` (package name and ids masked).

A few ``checked`` counts hang on wall-clock races that the schedule does
not fix, and differ between two runs of one package as much as between the
packages; each scenario names those in ``volatile`` and they are left out of
the comparison (and said why where they are named).

The scenarios are those of the JAX package's ``tests/test_chaos.py`` whose
workloads use only ported modules, the overload schedule of
``test_overload.py``, the tracing on/off schedule of ``test_reqtrace.py``
and the decode-replica kill of ``test_disagg.py`` on its tiny f32 decoder.
"""

import importlib
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_runtime import _norm  # noqa: E402
from test_torch_serve import _Side, _settled, reap_jax_serve_watchers  # noqa: E402
from test_torch_serve import _reference as _jax_tokens  # noqa: E402
from test_torch_serve import params  # noqa: E402,F401  (module fixture: the tiny decoder)

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _mod(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


@pytest.fixture(autouse=True)
def _clean():
    for name in PACKAGES:
        importlib.import_module(name + ".runtime.failpoints").reset()
        importlib.import_module(name + ".core.config").reset_config()
    yield
    reap_jax_serve_watchers(timeout=0.0)
    for name in PACKAGES:
        importlib.import_module(name).shutdown()
        importlib.import_module(name + ".runtime.failpoints").reset()
        importlib.import_module(name + ".core.config").reset_config()


@pytest.fixture(autouse=True, scope="module")
def _no_jax_runtime_left_behind():
    yield
    reap_jax_serve_watchers()  # the decode-kill scenario's JAX routers


def _summary(result, volatile=()):
    """What the parity rule compares of one ``ChaosResult``."""
    inv = result.invariants.to_dict() if result.invariants else None
    return {
        "ok": result.ok,
        "workload_error": repr(result.workload_error) if result.workload_error else None,
        "violations": inv and inv["violations"],
        "faults": result.faults,
        "kinds": [e["kind"] for e in result.events_applied],
        "checked": inv and {k: v for k, v in inv["checked"].items() if k not in volatile},
    }


def _both(scenario, *args, runs=2, volatile=()):
    """``scenario(rt, *args)`` ``runs`` times in each package; every run's
    summary must equal the JAX package's first. Returns the JAX package's
    and the port's outputs (each run: ``summary`` and ``extra``)."""
    outs = {}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        outs[name] = []
        for _ in range(runs):
            result, extra = scenario(rt, *args)
            outs[name].append({"summary": _norm(_summary(result, volatile)),
                               "extra": _norm(extra), "result": result})
    want = outs["ray_tpu"][0]["summary"]
    for name in PACKAGES:
        for i, run in enumerate(outs[name]):
            got = run["summary"]
            differ = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
            if differ.get("checked"):
                checked = {k: (got["checked"].get(k), v) for k, v in want["checked"].items()
                           if got["checked"].get(k) != v}
                differ["checked"] = checked
            assert not differ, (name, i, differ)
    return outs["ray_tpu"], outs["ray_tpu_torch"]


# --------------------------------------------------------------------------
# 2. put fault + object loss during lineage reconstruction (test_chaos.py:109)
# --------------------------------------------------------------------------
def scenario_put_fault_lineage(rt, seed):
    chaos, fp = _mod(rt, "chaos"), _mod(rt, "runtime.failpoints")
    exc = _mod(rt, "exceptions")
    rt.init(num_cpus=4)
    try:
        schedule = chaos.ChaosSchedule(
            [chaos.ChaosEvent(0.0, "arm", spec="object_store.put=raise(0.4)"),
             chaos.ChaosEvent(1.0, "lose_objects", fraction=0.6)],
            seed=seed, name="put-fault-lineage")
        seen = {}

        def workload():
            def produce(i):
                return i * 2

            f = rt.remote(produce).options(max_retries=5, execution="thread")
            task_refs = [f.remote(i) for i in range(12)]
            rt.wait(task_refs, num_returns=len(task_refs), timeout=30)
            put_refs = []
            for i in range(8):
                while True:  # application-level retry: each miss consumes a hit
                    try:
                        put_refs.append(rt.put(("blob", i)))
                        break
                    except fp.FailpointInjected:
                        continue
            time.sleep(1.3)  # past the lose_objects event
            seen["tasks"] = rt.get(task_refs, timeout=60)
            seen["puts"] = []
            for i, ref in enumerate(put_refs):
                try:
                    seen["puts"].append(rt.get(ref, timeout=30))
                except exc.ObjectLostError:
                    seen["puts"].append("lost")
            return task_refs + put_refs

        result = chaos.ChaosRunner(schedule, quiesce_timeout=60).run(workload)
        lose = [e for e in result.events_applied if e["kind"] == "lose_objects"]
        return result, {**seen, "lose": lose}
    finally:
        rt.shutdown()


def test_put_fault_during_lineage_reconstruction_matches_jax():
    # Which objects exist when the loss lands at t=1.0 (all 20, or fewer
    # when the puts lag on a loaded host), and so which are lost and rebuilt,
    # is a race of the workload against the timeline in both packages: the
    # counts that follow from it are left out; the fault log is not (each
    # put decision is indexed by hit).
    jax_runs, port_runs = _both(scenario_put_fault_lineage, 33, volatile=(
        "refs_resolved", "refs_failed_typed", "terminal_records", "tasks_with_retries"))
    for run in jax_runs + port_runs:
        assert run["result"].ok
        assert run["extra"]["tasks"] == [i * 2 for i in range(12)]
        assert all(p in (("blob", i), "lost") for i, p in enumerate(run["extra"]["puts"]))
        assert run["extra"]["lose"][0]["lost"] > 0
    assert any(f["fp"] == "object_store.put" for f in port_runs[0]["summary"]["faults"])


# --------------------------------------------------------------------------
# 3. worker-spawn failure during actor fan-out (test_chaos.py:162)
# --------------------------------------------------------------------------
def scenario_spawn_failure_fanout(rt, seed):
    chaos = _mod(rt, "chaos")
    rt.init(num_cpus=8, _system_config={"num_prestart_workers": 0})
    try:
        schedule = chaos.ChaosSchedule(
            [chaos.ChaosEvent(0.0, "arm", spec="worker_pool.spawn=raise(0.35)")],
            seed=seed, name="spawn-failure-fanout")
        seen = []

        class Echo:
            def __init__(self, tag):
                self.tag = tag

            def ping(self):
                return self.tag

        def workload():
            refs, actors = [], []
            for i in range(5):
                a = rt.remote(Echo).options(max_restarts=25).remote(i)
                ref = a.ping.remote()
                seen.append(rt.get(ref, timeout=60))
                refs.append(ref)
                actors.append(a)
            for a in actors:
                rt.kill(a)
            return refs

        result = chaos.ChaosRunner(schedule, quiesce_timeout=90).run(workload)
        return result, {"pings": seen}
    finally:
        rt.shutdown()


def test_worker_spawn_failure_during_fanout_matches_jax():
    jax_runs, port_runs = _both(scenario_spawn_failure_fanout, 47)
    for run in jax_runs + port_runs:
        assert run["result"].ok and run["extra"]["pings"] == list(range(5))
    assert any(f["fp"] == "worker_pool.spawn" for f in port_runs[0]["summary"]["faults"])


# --------------------------------------------------------------------------
# 5. node kill through the runner (test_chaos.py:315)
# --------------------------------------------------------------------------
def scenario_node_kill(rt, seed):
    chaos = _mod(rt, "chaos")
    cluster = rt.init(num_cpus=2)
    try:
        cluster.add_node({"CPU": 2})
        schedule = chaos.ChaosSchedule([chaos.ChaosEvent(0.4, "kill_node", index=0)],
                                       seed=seed, name="node-kill")
        seen = {}

        def workload():
            def slow_double(i):
                time.sleep(0.8)
                return i * 2

            f = rt.remote(slow_double).options(max_retries=4, execution="thread",
                                               scheduling_strategy="SPREAD")
            refs = [f.remote(i) for i in range(8)]
            seen["values"] = rt.get(refs, timeout=60)
            return refs

        result = chaos.ChaosRunner(schedule, quiesce_timeout=90).run(workload)
        killed = [e for e in result.events_applied if e["kind"] == "kill_node"]
        return result, {**seen, "killed": killed,
                        "dead_nodes": sum(1 for n in cluster.nodes.values() if n.dead)}
    finally:
        rt.shutdown()


def test_node_kill_through_runner_matches_jax():
    # terminal_records / tasks_with_retries: how many of the 8 tasks were on
    # the victim when the kill landed at t=0.4 is a race of the spread
    # placement against the timeline, in both packages
    jax_runs, port_runs = _both(scenario_node_kill, 5, runs=1,
                                volatile=("terminal_records", "tasks_with_retries"))
    for run in jax_runs + port_runs:
        assert run["result"].ok and run["extra"]["values"] == [i * 2 for i in range(8)]
        assert run["extra"]["dead_nodes"] == 1 and "node" in run["extra"]["killed"][0]


def _after_event(event, sleep_until, timeout_s=60.0):
    """A runner's ``_sleep_until`` that also waits (bounded) for ``event``:
    the timeline's next event lands no earlier than its offset and no
    earlier than the point the workload marks."""
    def wait(deadline):
        sleep_until(deadline)
        event.wait(timeout_s)
    return wait


# --------------------------------------------------------------------------
# 9. head outage mid-workload (test_chaos.py:698)
# --------------------------------------------------------------------------
def scenario_head_outage(rt, seed):
    chaos, fp = _mod(rt, "chaos"), _mod(rt, "runtime.failpoints")
    cluster = rt.init(num_cpus=2)
    try:
        cluster.add_node({"CPU": 2})
        schedule = chaos.ChaosSchedule(
            [chaos.ChaosEvent(0.0, "arm", spec="object_store.put=raise(0.4)"),
             chaos.ChaosEvent(2.0, "kill_head"),
             chaos.ChaosEvent(3.5, "restart_head")],
            seed=seed, name="head-outage")
        seen = {}

        def retried_puts(tag, n):
            out = []
            for i in range(n):
                while True:
                    try:
                        out.append(rt.put((tag, i)))
                        break
                    except fp.FailpointInjected:
                        continue
            return out

        class Counter:
            def __init__(self):
                self.n = 0

            def add(self, k):
                self.n += k
                return self.n

        pre_done = threading.Event()

        def workload():
            c = rt.remote(Counter).options(name="outage-counter", max_restarts=1).remote()
            refs = retried_puts("pre", 6)
            seen["pre"] = rt.get([c.add.remote(1) for _ in range(5)], timeout=30)
            cluster.control.kv.put(b"outage_marker", b"pre-kill")
            pre_done.set()
            # the outage is awaited by its events (the head down, then back),
            # not by a fixed clock that can close before restart_head lands
            deadline = time.monotonic() + 60.0
            while not (cluster.head_restarts >= 1 and not cluster._head_down):
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
                if cluster._head_down:
                    cluster.control.kv.put(b"doomed_marker", b"lost")
            seen["restarts"] = cluster.head_restarts
            seen["kept"] = cluster.control.kv.get(b"outage_marker")
            seen["doomed"] = cluster.control.kv.get(b"doomed_marker")
            refs += retried_puts("post", 6)
            seen["after"] = rt.get(rt.get_actor("outage-counter").add.remote(1), timeout=30)
            return refs

        runner = chaos.ChaosRunner(schedule, quiesce_timeout=90)
        # the kill lands at 2.0 s or once the pre-outage half of the workload
        # is done, whichever is later: on a busy host that half can outlast
        # 2.0 s, and a kill before the marker and the five calls are recorded
        # loses them with the head (F10)
        runner._sleep_until = _after_event(pre_done, runner._sleep_until)
        result = runner.run(workload)
        restart = next(e for e in result.events_applied if e["kind"] == "restart_head")
        return result, {**seen, "reconciled": restart["reconciled"] >= 1}
    finally:
        rt.shutdown()


def test_head_outage_mid_workload_matches_jax():
    jax_runs, port_runs = _both(scenario_head_outage, 61)
    want = {"pre": [1, 2, 3, 4, 5], "restarts": 1, "kept": b"pre-kill", "doomed": None,
            "after": 6, "reconciled": True}
    for run in jax_runs + port_runs:
        assert run["result"].ok and run["extra"] == want
    assert port_runs[0]["summary"]["faults"]
    assert port_runs[0]["summary"]["kinds"] == ["arm", "kill_head", "restart_head"]


# --------------------------------------------------------------------------
# 11. leased-worker kill mid-workload (test_chaos.py:927)
# --------------------------------------------------------------------------
def scenario_leased_worker_kill(rt, seed):
    chaos = _mod(rt, "chaos")
    cluster = rt.init(num_cpus=2, _system_config={"num_prestart_workers": 0,
                                                  "inproc_task_threshold_s": 0.0})
    try:
        schedule = chaos.ChaosSchedule(
            [chaos.ChaosEvent(0.0, "arm", spec="scheduler.dispatch=raise(0.12)")],
            seed=seed, name="leased-worker-kill")
        seen = {}

        def workload():
            def bump():
                return 1

            f = rt.remote(bump).options(max_retries=25)
            pool = cluster.head_node.worker_pool
            seen["burst1"] = rt.get([f.remote() for _ in range(15)], timeout=90)
            seen["reuse"] = cluster.lease_manager.reuse_hits >= 10
            seen["sequential"] = [rt.get(f.remote(), timeout=90) for _ in range(3)]
            with pool._lock:
                pinned = list(pool._lease_pins.values())
            seen["pinned"] = bool(pinned)
            for w in pinned:
                w.proc.kill()
            for w in pinned:
                w.proc.wait(timeout=10)
            refs = [f.remote() for _ in range(15)]
            seen["burst2"] = rt.get(refs, timeout=90)
            return refs

        result = chaos.ChaosRunner(schedule, quiesce_timeout=90).run(workload)
        return result, seen
    finally:
        rt.shutdown()


def test_leased_worker_kill_mid_push_matches_jax():
    # A task of the second burst dispatched to the killed worker before its
    # pool has read the death fails as a worker crash and runs again: how
    # many do is a race with the pool's reader thread, in both packages
    jax_runs, port_runs = _both(scenario_leased_worker_kill, 61,
                                volatile=("terminal_records", "tasks_with_retries"))
    want = {"burst1": [1] * 15, "reuse": True, "sequential": [1] * 3, "pinned": True,
            "burst2": [1] * 15}
    for run in jax_runs + port_runs:
        assert run["result"].ok and run["extra"] == want
    assert any(f["fp"] == "scheduler.dispatch" for f in port_runs[0]["summary"]["faults"])


# --------------------------------------------------------------------------
# 12. the partition-heal matrix (test_chaos.py:1084) and its CLI check
# --------------------------------------------------------------------------
_PARTITION_HEAL_SCHEDULE = {
    "name": "partition-heal",
    "events": [
        {"t": 0.0, "kind": "arm", "spec": "scheduler.dispatch=raise(0.08)"},
        {"t": 0.2, "kind": "slow_node", "index": 0, "delay": 0.05},
        {"t": 0.45, "kind": "partition_node", "index": 0},
        {"t": 0.9, "kind": "heal_partition"},
        {"t": 1.1, "kind": "disarm"},
    ],
}


def scenario_partition_heal(rt, seed):
    chaos = _mod(rt, "chaos")
    strategy = _mod(rt, "runtime.scheduler").NodeAffinitySchedulingStrategy
    sched_dict = dict(_PARTITION_HEAL_SCHEDULE, seed=seed)
    errors = chaos.validate_schedule(sched_dict, num_nodes=1)
    cluster = rt.init(num_cpus=1)
    try:
        victim = cluster.add_node({"CPU": 2})

        def bump(i):
            time.sleep(0.12)
            return i + 1

        def workload():
            f = rt.remote(bump).options(
                max_retries=6, scheduling_strategy=strategy(victim.node_id, soft=True))
            return [f.remote(i) for i in range(20)]

        result = chaos.ChaosRunner(chaos.ChaosSchedule.from_dict(sched_dict),
                                   quiesce_timeout=90).run(workload)
        fresh = [n for n in cluster.nodes.values() if not n.dead and n is not cluster.head_node]

        def after_heal(x):
            return x * 10

        after = rt.get(rt.remote(after_heal).options(
            scheduling_strategy=strategy(fresh[0].node_id)).remote(4), timeout=30)
        return result, {"validate": errors, "fresh_nodes": len(fresh), "after_heal": after,
                        "victim_dead": victim.dead}
    finally:
        rt.shutdown()


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_partition_heal_matrix_matches_jax(seed):
    # Whether a task is still in flight on the victim when the partition
    # lands at t=0.45 (and so whether its fenced commit is rejected and it
    # is resubmitted) is a race against 0.12 s tasks on a loaded host: the
    # fence counts, and the terminal and retry counts they move, vary
    # between two runs of either package. The fault log does not (dispatch
    # decisions are indexed by hit, not by time).
    jax_runs, port_runs = _both(scenario_partition_heal, seed, volatile=(
        "terminal_records", "tasks_with_retries", "fence_events", "fenced_tasks"))
    for run in jax_runs + port_runs:
        assert run["result"].ok
        assert run["extra"] == {"validate": [], "fresh_nodes": 1, "after_heal": 40,
                                "victim_dead": True}
    assert port_runs[0]["summary"]["kinds"] == [
        "arm", "slow_node", "partition_node", "heal_partition", "disarm"]


def test_chaos_validate_cli_partition_heal_matches_jax(tmp_path, capsys):
    out = {}
    for name in PACKAGES:
        validate_cli = importlib.import_module(name + ".chaos.schedule").validate_cli
        path = str(tmp_path / f"{name}.json")
        with open(path, "w") as f:
            json.dump(dict(_PARTITION_HEAL_SCHEDULE, seed=1), f)

        class Args:
            schedule = path
            nodes = 1

        rcs = [validate_cli(Args())]
        with open(path, "w") as f:
            json.dump({"seed": 1, "events": [{"t": 0.0, "kind": "heal_partition"}]}, f)
        rcs.append(validate_cli(Args()))
        Args.schedule = str(tmp_path / "missing.json")
        rcs.append(validate_cli(Args()))
        with open(path, "w") as f:
            f.write("{not json")
        Args.schedule = path
        rcs.append(validate_cli(Args()))
        text = capsys.readouterr()
        out[name] = _norm({"rcs": rcs, "out": text.out.replace(name, "<pkg>"),
                           "err": text.err.replace(name, "<pkg>")})
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    assert out["ray_tpu_torch"]["rcs"] == [0, 1, 1, 1]


# --------------------------------------------------------------------------
# the schedule codec and schema (test_chaos.py:993, test_overload.py:862)
# --------------------------------------------------------------------------
def test_schedule_json_round_trip_matches_jax(tmp_path):
    out = {}
    for name in PACKAGES:
        chaos = importlib.import_module(name + ".chaos")
        sched = chaos.ChaosSchedule(
            [chaos.ChaosEvent(2.0, "kill_node", index=1),
             chaos.ChaosEvent(0.0, "arm", spec="rpc.call=delay(0.1,0.2)"),
             chaos.ChaosEvent(1.0, "partition", fp="agent.heartbeat", duration=2.0)],
            seed=9, name="round-trip")
        path = str(tmp_path / f"{name}.json")
        sched.save(path)
        loaded = chaos.ChaosSchedule.load(path, seed=123)
        try:
            chaos.ChaosEvent(0.0, "explode")
        except ValueError as exc:
            err = str(exc)
        out[name] = {"json": open(path).read(), "seed": loaded.seed, "name": loaded.name,
                     "events": [e.to_dict() for e in loaded.events],
                     "same": [e.to_dict() for e in loaded.events] == [
                         e.to_dict() for e in sched.events],
                     "duration": loaded.duration(), "repr": repr(loaded.events[0]),
                     "unknown": err}
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    assert out["ray_tpu_torch"]["seed"] == 123 and out["ray_tpu_torch"]["duration"] == 3.0


def test_schedule_kinds_and_schema_match_jax():
    jsched = importlib.import_module("ray_tpu.chaos.schedule")
    tsched = importlib.import_module("ray_tpu_torch.chaos.schedule")
    assert tsched._KINDS == jsched._KINDS and len(tsched._KINDS) == 15
    assert tsched._EVENT_SCHEMA == jsched._EVENT_SCHEMA


# one schedule a kind: valid params, then every way each goes wrong
_VALIDATE_CASES = {
    "arm": [{"spec": "object_store.put=raise(0.4)"}, {"spec": "nope=explode(2)"}, {},
            {"spec": 3}],
    "disarm": [{}, {"name": "x"}, {"name": 1}],
    "partition": [{"fp": "agent.heartbeat", "duration": 2.0}, {"fp": "x", "duration": 0},
                  {"duration": 1.0}],
    "kill_node": [{"index": 0}, {"index": -1}, {"index": 3}, {"index": True}],
    "lose_objects": [{"fraction": 0.5}, {"fraction": 1.5}, {"fraction": "half"}],
    "add_node": [{"resources": {"CPU": 2}, "labels": {"zone": "a"}}, {"resources": 2}],
    "drain_node": [{"index": 0, "timeout": 5}, {"index": 0, "grace": 1}],
    "kill_head": [{}, {"index": 0}],
    "restart_head": [{}],
    "slow_node": [{"index": 0, "delay": 0.5}, {"delay": -1}, {"index": 9}],
    "partition_node": [{"index": 0}, {"index": -2}],
    "heal_partition": [{}],
    "overload": [{"tasks": 10, "cpus": 2, "hold_s": 0.1},
                 {"tasks": 0, "cpus": -1, "hold_s": -2, "bogus": 1}],
    "preempt_gang_member": [{"job": "j", "index": 0, "graceful": False}, {"index": -1},
                            {"graceful": "yes"}],
    "kill_decode_replica": [{"deployment": "LLMServer", "role": "decode", "index": 0},
                            {"role": "router"}, {"index": -1}],
}


@pytest.mark.parametrize("kind", sorted(_VALIDATE_CASES))
def test_validate_schedule_matches_jax(kind):
    out = {}
    for name in PACKAGES:
        validate = importlib.import_module(name + ".chaos.schedule").validate_schedule
        rows = []
        for params in _VALIDATE_CASES[kind]:
            events = [{"t": 0.5, "kind": kind, **params}]
            if kind == "restart_head":
                events.insert(0, {"t": 0.1, "kind": "kill_head"})
            if kind == "heal_partition":
                events.insert(0, {"t": 0.1, "kind": "partition_node"})
            rows.append([validate({"seed": 1, "events": events}, num_nodes=n)
                         for n in (None, 1)])
        out[name] = rows
    out["ray_tpu"] = _norm(out["ray_tpu"])
    out["ray_tpu_torch"] = _norm(out["ray_tpu_torch"])
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    assert out["ray_tpu_torch"][0] == [[], []] or kind in ("kill_head",)


def test_validate_schedule_document_errors_match_jax():
    docs = [[], {"events": {}}, {"seed": "x"}, {"seed": 1, "events": [3, {"t": 1}]},
            {"events": [{"kind": "arm", "spec": "a=drop(0.1)", "t": -1}]},
            {"events": [{"kind": "kill_head", "t": 0}, {"kind": "kill_head", "t": 1}]},
            {"events": [{"kind": "restart_head", "t": "soon"}]}]
    out = {name: [importlib.import_module(name + ".chaos").validate_schedule(d) for d in docs]
           for name in PACKAGES}
    assert _norm(out["ray_tpu_torch"]) == _norm(out["ray_tpu"])
    assert all(out["ray_tpu_torch"])


# --------------------------------------------------------------------------
# the kinds with nothing to act on: the JAX package's own skipped results
# --------------------------------------------------------------------------
def scenario_skipped_kinds(rt, seed):
    chaos = _mod(rt, "chaos")
    rt.init(num_cpus=2)
    try:
        events = [chaos.ChaosEvent(0.0, kind, **p) for kind, p in (
            ("kill_node", {"index": 0}), ("drain_node", {}), ("slow_node", {"index": 2}),
            ("partition_node", {}), ("heal_partition", {}), ("preempt_gang_member", {}),
            ("preempt_gang_member", {"job": "missing"}), ("kill_decode_replica", {}),
            ("lose_objects", {"fraction": 0.0}), ("disarm", {"name": "nothing.armed"}))]
        result = chaos.ChaosRunner(chaos.ChaosSchedule(events, seed=seed),
                                   quiesce_timeout=30).run(lambda: 7)
        return result, {"applied": result.events_applied, "value": result.workload_result,
                        "to_dict_keys": sorted(result.to_dict())}
    finally:
        rt.shutdown()


def test_kinds_without_a_target_skip_as_in_jax():
    jax_runs, port_runs = _both(scenario_skipped_kinds, 3, runs=1)
    assert port_runs[0]["extra"] == jax_runs[0]["extra"]
    applied = port_runs[0]["extra"]["applied"]
    assert sum("skipped" in e for e in applied) == 8 and port_runs[0]["extra"]["value"] == 7


def scenario_elastic_kinds(rt, seed):
    """add_node, slow_node, drain_node and kill_node on the in-process
    cluster, with objects on the drained node to evacuate."""
    chaos, fp = _mod(rt, "chaos"), _mod(rt, "runtime.failpoints")
    strategy = _mod(rt, "runtime.scheduler").NodeAffinitySchedulingStrategy
    cluster = rt.init(num_cpus=2)
    try:
        schedule = chaos.ChaosSchedule(
            [chaos.ChaosEvent(0.0, "arm", spec="object_store.put=raise(0.3)"),
             chaos.ChaosEvent(0.0, "add_node", resources={"CPU": 2}, labels={"zone": "b"}),
             chaos.ChaosEvent(0.0, "add_node", resources={"CPU": 1}),
             chaos.ChaosEvent(0.0, "slow_node", index=1, delay=0.01),
             chaos.ChaosEvent(2.0, "drain_node", index=0, timeout=30),
             chaos.ChaosEvent(2.5, "kill_node", index=0)],
            seed=seed, name="elastic")
        seen = {}

        def make(i):
            return np.full(1000, i)

        def workload():
            nodes = [n for n in cluster.nodes.values() if n is not cluster.head_node]
            f = rt.remote(make).options(execution="thread", max_retries=3, num_cpus=0,
                                        scheduling_strategy=strategy(nodes[0].node_id, soft=True))
            refs = [f.remote(i) for i in range(4)]
            rt.wait(refs, num_returns=4, timeout=30)
            puts = []
            for i in range(4):
                while True:
                    try:
                        puts.append(rt.put(i))
                        break
                    except fp.FailpointInjected:
                        continue
            time.sleep(3.0)  # past the drain and the kill
            seen["values"] = [int(a[0]) for a in rt.get(refs, timeout=60)]
            seen["puts"] = rt.get(puts, timeout=30)
            return refs + puts

        result = chaos.ChaosRunner(schedule, quiesce_timeout=60).run(workload)
        drained = next(e for e in result.events_applied if e["kind"] == "drain_node")
        return result, {**seen, "drain": {k: drained[k] for k in ("outcome", "evacuated")},
                        "live": sum(1 for n in cluster.nodes.values() if not n.dead)}
    finally:
        rt.shutdown()


def test_elastic_kinds_run_on_the_in_process_cluster_as_in_jax():
    jax_runs, port_runs = _both(scenario_elastic_kinds, 17, runs=1)
    for run in jax_runs + port_runs:
        assert run["result"].ok
        assert run["extra"]["values"] == [0, 1, 2, 3] and run["extra"]["puts"] == [0, 1, 2, 3]
        assert run["extra"]["drain"]["outcome"] == "ok" and run["extra"]["live"] == 1
    assert port_runs[0]["extra"] == jax_runs[0]["extra"]


# --------------------------------------------------------------------------
# the overload kind and invariant 11 (test_overload.py:804)
# --------------------------------------------------------------------------
def scenario_overload(rt, seed):
    chaos = _mod(rt, "chaos")
    rt.init(num_cpus=1, _system_config={"demand_queue_max_entries": 8,
                                        "infeasible_task_timeout_s": 2.0})
    try:
        sched = chaos.ChaosSchedule.from_dict({
            "seed": seed,
            "events": [
                {"t": 0.0, "kind": "arm", "spec": "scheduler.dispatch=delay(0.001,0.2)"},
                {"t": 0.05, "kind": "overload", "tasks": 24, "cpus": 4},
                {"t": 0.1, "kind": "overload", "tasks": 16, "cpus": 1, "hold_s": 0.02},
            ],
        })

        def bump(x):
            return x + 1

        def workload():
            f = rt.remote(bump).options(max_retries=2)
            return [f.remote(i) for i in range(30)]

        result = chaos.ChaosRunner(sched, quiesce_timeout=60).run(workload)
        injected = [e for e in result.events_applied if e["kind"] == "overload"]
        return result, {"injected": injected}
    finally:
        rt.shutdown()


def test_overload_schedule_invariant_11_matches_jax():
    jax_runs, port_runs = _both(scenario_overload, 7)
    for run in jax_runs + port_runs:
        assert run["result"].ok
        assert run["summary"]["checked"]["overload_sheds"] >= 8
        assert run["extra"] == jax_runs[0]["extra"]
    assert len(port_runs[0]["summary"]["faults"]) > 0


# --------------------------------------------------------------------------
# tracing on vs off leaves the fault log unchanged (test_reqtrace.py:424)
# --------------------------------------------------------------------------
def scenario_tracing_on_off(rt, seed):
    chaos, fp = _mod(rt, "chaos"), _mod(rt, "runtime.failpoints")
    reqtrace = _mod(rt, "observability.reqtrace")
    cfg = _mod(rt, "core.config").get_config()
    rt.init(num_cpus=4)
    try:
        schedule = chaos.ChaosSchedule(
            [chaos.ChaosEvent(0.0, "arm", spec="object_store.put=raise(0.4)")],
            seed=seed, name="put-fault-traced")
        got = []

        def workload():
            refs = []
            for i in range(10):
                tr = reqtrace.start_trace(route="/llm", deployment="chaosd")
                if tr is not None:
                    tr.mark("router_in")
                    tr.mark("replica_in")
                while True:
                    try:
                        refs.append(rt.put(("blob", i)))
                        break
                    except fp.FailpointInjected:
                        continue
                reqtrace.finish_trace(tr, "ok")
            got.append(rt.get(refs, timeout=30))
            return refs

        reqtrace.global_trace_store().reset()
        runs = []
        try:
            for on in (True, False):
                cfg.serve_request_trace = on
                runs.append(chaos.ChaosRunner(schedule, quiesce_timeout=60).run(workload))
                if on:
                    traced = len(reqtrace.global_trace_store().snapshot(limit=100)["recent"])
        finally:
            cfg.serve_request_trace = True
        same = runs[0].same_faults(runs[1])
        return runs[1], {"same_on_off": same, "on_ok": runs[0].ok, "traced": traced,
                         "values": got}
    finally:
        rt.shutdown()


def test_fault_log_identical_tracing_on_vs_off_matches_jax():
    jax_runs, port_runs = _both(scenario_tracing_on_off, 77, runs=1)
    want = {"same_on_off": True, "on_ok": True, "traced": 10,
            "values": [[("blob", i) for i in range(10)]] * 2}
    assert jax_runs[0]["extra"] == port_runs[0]["extra"] == _norm(want)
    assert port_runs[0]["summary"]["faults"]


# --------------------------------------------------------------------------
# the builtin workloads of `rt chaos run` (run_cli)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("workload", ["fanout", "actor"])
def test_run_cli_builtin_workloads_match_jax(workload, tmp_path, capsys):
    sched = {"seed": 5, "events": [{"t": 0.0, "kind": "arm",
                                    "spec": "object_store.put=raise(0.2)"}]}
    path = tmp_path / "s.json"
    path.write_text(json.dumps(sched))
    out = {}
    for name in PACKAGES:
        runner = importlib.import_module(name + ".chaos.runner")

        class Args:
            schedule = str(path)
            seed = 11
            num_cpus = 2
            timeout = 60.0

        Args.workload = workload
        rc = runner.run_cli(Args())
        doc = json.loads(capsys.readouterr().out)
        # which of the concurrent tasks draws a failing put decision (one
        # task may draw two) is a race: tasks_with_retries is left out
        checked = {k: v for k, v in doc["invariants"]["checked"].items()
                   if k != "tasks_with_retries"}
        out[name] = _norm({"rc": rc, "ok": doc["ok"], "faults": doc["faults"],
                           "kinds": [e["kind"] for e in doc["events_applied"]],
                           "checked": checked})
        try:
            runner.builtin_workload("nope", None)
        except ValueError as exc:
            out[name]["unknown"] = str(exc)
        path.write_text(json.dumps({"events": [{"kind": "explode"}]}))
        out[name]["invalid_rc"] = runner.run_cli(Args())
        capsys.readouterr()
        path.write_text(json.dumps(sched))
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    assert out["ray_tpu_torch"]["rc"] == 0 and out["ray_tpu_torch"]["invalid_rc"] == 1


# --------------------------------------------------------------------------
# the decode-replica kill (test_disagg.py:376-450), tiny f32 decoder
# --------------------------------------------------------------------------
_CHAOS_PROMPT = [5, 3, 7, 1, 9, 2, 8, 4, 6, 1, 2, 3, 4, 5, 6, 7, 8, 9]


def scenario_disagg_decode_kill(rt, seed, params, refs):
    side = _Side(rt.__name__, params)
    serve, fp, chaos = side.serve, side.failpoints, _mod(rt, "chaos")
    migration_error = _mod(rt, "serve.disagg").KVMigrationError
    rt.init(num_cpus=4)
    try:
        schedule = chaos.ChaosSchedule(
            [chaos.ChaosEvent(0.8, "kill_decode_replica", deployment="LLMServer",
                              role="decode", index=0)],
            seed=seed, name="disagg-decode-kill")
        seen = {"phase2": []}

        def workload():
            t_start = time.monotonic()
            serve.start(http_port=0)
            handle = serve.run(side.llm_app(deployment_kw={"roles": {"prefill": 1, "decode": 2}},
                                            max_batch_size=4, max_seq_len=64), route_prefix=None)
            ctls = list(side.cluster().serve_controllers.values())
            deadline = time.monotonic() + 30
            while (ctls[0].pool_status().get("LLMServer", {}).get("decode", {})
                   .get("replicas", 0) < 2 and time.monotonic() < deadline):
                time.sleep(0.02)
            _settled(handle)
            try:  # races the scheduled kill
                r = handle.remote({"prompt": _CHAOS_PROMPT, "max_tokens": 4}).result(timeout=60)
                seen["phase1"] = r["tokens"] == refs[tuple(_CHAOS_PROMPT)]
            except migration_error:
                seen["phase1"] = "KVMigrationError"
            time.sleep(max(0.0, 2.0 - (time.monotonic() - t_start)))
            _settled(handle)
            fp.arm("disagg.decode_call=raise(0.4)")
            for i in range(5):
                p = _CHAOS_PROMPT + [i + 1]
                try:
                    r = handle.remote({"prompt": p, "max_tokens": 3}).result(timeout=60)
                    seen["phase2"].append(r["tokens"])
                except migration_error:
                    seen["phase2"].append("KVMigrationError")
            serve.shutdown()
            return sum(1 for x in seen["phase2"] if x == "KVMigrationError")

        result = chaos.ChaosRunner(schedule, quiesce_timeout=90).run(workload)
        kills = [e for e in result.events_applied if e["kind"] == "kill_decode_replica"]
        return result, {**seen, "kills": kills}
    finally:
        serve.shutdown()
        rt.shutdown()


def test_decode_replica_kill_matches_jax(params):
    jp = params[0]
    refs = {tuple(_CHAOS_PROMPT): _jax_tokens(jp, _CHAOS_PROMPT, 4)}
    for i in range(5):
        p = _CHAOS_PROMPT + [i + 1]
        refs[tuple(p)] = _jax_tokens(jp, p, 3)
    # kv_migrations: phase 1 races the kill at t=0.8 (its request may stage
    # once, or twice through a re-prefill), in both packages
    jax_runs, port_runs = _both(scenario_disagg_decode_kill, 41, params, refs,
                                volatile=("kv_migrations", "terminal_records",
                                          "tasks_with_retries"))
    for run in jax_runs + port_runs:
        assert run["result"].ok and run["result"].invariants.checked["kv_migrations"] >= 5
        assert len(run["extra"]["kills"]) == 1 and "skipped" not in run["extra"]["kills"][0]
        assert run["extra"]["phase1"] in (True, "KVMigrationError")
        for i, toks in enumerate(run["extra"]["phase2"]):
            assert toks == "KVMigrationError" or toks == refs[tuple(_CHAOS_PROMPT + [i + 1])]
        assert run["extra"]["phase2"] == port_runs[0]["extra"]["phase2"]
    faults = port_runs[0]["summary"]["faults"]
    assert faults and all(f["fp"] == "disagg.decode_call" for f in faults)
