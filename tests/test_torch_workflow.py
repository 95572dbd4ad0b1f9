"""The port's durable workflows (``ray_tpu_torch.workflow``) against the JAX
package's, case by case of the workflow tests of ``tests/test_util_workflow.py``
and the HTTP event trigger of ``tests/test_dashboard_jobs.py``.

Each package runs every scenario once under one runtime of its own
(``init(num_cpus=8, include_dashboard=True)``), each scenario with a
storage directory of its own; outputs, statuses and the durable step lists
must be equal.  Both packages run in this one process, so
``test_default_storage_keeps_each_package_apart_in_one_process`` also runs
one workflow id in both packages' default storage at once: each package's
checkpoints live under its own base, and a resume in one never sees the
other's steps.
"""

import importlib
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch_runtime_tasks as tasks

torch = pytest.importorskip("torch")

PACKAGES = ("ray_tpu", "ray_tpu_torch")


class _Side:
    def __init__(self, name):
        self.name = name
        self.rt = importlib.import_module(name)
        self.wf = importlib.import_module(name + ".workflow")
        self.events = importlib.import_module(name + ".workflow.events")
        self.storage = importlib.import_module(name + ".workflow.storage")

    def step(self, fn, **opts):
        return self.rt.remote(fn).options(**opts) if opts else self.rt.remote(fn)


def sc_run_and_output(s, tmp):
    wf = s.wf
    dag = s.step(tasks._wf_double).bind(s.step(tasks._wf_add).bind(1, 2))
    result = wf.run(dag, workflow_id="wf1")
    meta = wf.get_metadata("wf1")
    return {"result": result, "status": wf.get_status("wf1"), "output": wf.get_output("wf1"),
            "listed": {"workflow_id": "wf1", "status": "SUCCESSFUL"} in wf.list_all(),
            "filtered": wf.list_all("FAILED"), "meta": meta,
            "missing": type(_raises(lambda: wf.get_output("nope"))).__name__}


def sc_resume_skips_completed(s, tmp):
    wf = s.wf
    marker = os.path.join(tmp, "fail_once")
    count = os.path.join(tmp, "count")
    open(marker, "w").close()
    a = s.step(tasks._wf_count).bind(count, s.step(tasks._wf_ten).bind())
    dag = s.step(tasks._wf_fail_once).bind(a, marker)
    err = _raises(lambda: wf.run(dag, workflow_id="wf2"))
    failed = wf.get_status("wf2")
    steps_failed = wf.get_metadata("wf2")["step_names"]
    out = wf.resume("wf2")
    with open(count) as f:
        runs = f.read().count("ran")
    return {"error": type(err).__name__ if err else None, "failed": failed, "resumed": out,
            "status": wf.get_status("wf2"), "steps_after_failure": steps_failed,
            "counted_step_runs": runs, "steps": wf.get_metadata("wf2")["step_names"]}


def sc_run_async_and_output_async(s, tmp):
    wf = s.wf
    fut = wf.run_async(s.step(tasks._wf_slow).bind(), workflow_id="wf3")
    value = fut.result(timeout=30)
    later = wf.get_output_async("wf3").result(timeout=30)
    missing = wf.get_output_async("nope")
    return {"value": value, "later": later,
            "missing": type(missing.exception(timeout=5)).__name__}


def sc_delete(s, tmp):
    wf = s.wf
    wf.run(s.step(tasks._wf_add).bind(0, 1), workflow_id="wf4")
    wf.delete("wf4")
    return {"status": wf.get_status("wf4"), "listed": wf.list_all()}


def sc_wait_for_event_and_replay(s, tmp):
    wf = s.wf
    wf.deliver_event("approval", {"approved": True})
    evt = wf.wait_for_event(wf.QueueEventListener, "approval", 10.0)
    dag = s.step(tasks._wf_combine).bind(evt, 7)
    out = wf.run(dag, workflow_id="wf_events")
    replay = wf.resume("wf_events")
    return {"out": out, "replay": replay, "waiters": s.events.has_waiters("approval")}


def sc_timer_listener_fires(s, tmp):
    t0 = time.monotonic()
    val = s.events.TimerListener().poll_for_event(0.05)
    return {"waited": time.monotonic() - t0 >= 0.05, "float": isinstance(val, float),
            "abstract": type(_raises(lambda: s.wf.EventListener().poll_for_event())).__name__}


def sc_options_catch_and_no_checkpoint(s, tmp):
    wf = s.wf
    boom = s.step(tasks._wf_boom).options(**wf.options(catch_exceptions=True))
    count = os.path.join(tmp, "count")
    plain = s.step(tasks._wf_count).options(**wf.options(checkpoint=False))
    caught = wf.run(boom.bind(3), workflow_id="wf_catch")
    again = wf.run(s.step(tasks._wf_double).bind(plain.bind(count, 4)), workflow_id="wf_nock")
    wf.resume("wf_nock")
    with open(count) as f:
        runs = f.read().count("ran")
    return {"caught": (caught[0], type(caught[1]).__name__, str(caught[1])), "again": again,
            "unchecked_runs": runs, "steps": wf.get_metadata("wf_nock")["step_names"],
            "bad_key": type(_raises(lambda: wf.options(bogus=1))).__name__}


def sc_cancel_and_resume(s, tmp):
    wf = s.wf
    wf.run(s.step(tasks._wf_add).bind(1, 1), workflow_id="wf_cancel")
    wf.cancel("wf_cancel")
    canceled = wf.get_status("wf_cancel")
    out = wf.resume("wf_cancel")
    return {"canceled": canceled, "resumed": out, "status": wf.get_status("wf_cancel"),
            "resume_unknown": type(_raises(lambda: wf.resume("never_ran"))).__name__,
            "unknown_status": wf.get_status("never_ran")}


def sc_sleep_step(s, tmp):
    wf = s.wf
    t0 = time.monotonic()
    first = wf.run(wf.sleep(0.1), workflow_id="wf_sleep")
    slept = time.monotonic() - t0 >= 0.1
    return {"first": first, "slept": slept, "replay": wf.resume("wf_sleep")}


def sc_http_event_trigger(s, tmp):
    wf = s.wf
    url = s.rt.get_cluster().dashboard.url
    dag = s.step(tasks._wf_unwrap).bind(wf.wait_for_event(wf.QueueEventListener, "release", 30.0))
    result = {}
    t = threading.Thread(target=lambda: result.update(value=wf.run(dag, workflow_id="wf_http")))
    t.start()
    # the trigger answers 404 until the workflow waits on the event (its
    # step starts on its own thread): retry until it is delivered
    deadline = time.monotonic() + 30
    refused, delivered = set(), None
    while delivered is None and time.monotonic() < deadline:
        req = urllib.request.Request(url + "/api/workflows/events/release",
                                     data=json.dumps({"decision": "approved"}).encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                delivered = json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            refused.add(exc.code)
            time.sleep(0.05)
    t.join(timeout=60)
    return {"value": result.get("value"), "delivered": delivered,
            "refused_only_404": refused <= {404}}


def _raises(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001
        return exc
    return None


SCENARIOS = [fn for n, fn in sorted(globals().items()) if n.startswith("sc_")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {name: {} for name in PACKAGES}
    for name in PACKAGES:
        side = _Side(name)
        side.rt.init(num_cpus=8, include_dashboard=True)
        try:
            for fn in SCENARIOS:
                tmp = str(tmp_path_factory.mktemp(f"{name}_{fn.__name__}"))
                side.wf.init(os.path.join(tmp, "wf"))
                try:
                    out[name][fn.__name__[3:]] = fn(side, tmp)
                except Exception as exc:  # noqa: BLE001 - reported by the test
                    out[name][fn.__name__[3:]] = ("raised", repr(exc))
        finally:
            side.rt.shutdown()
    return out


EXPECT = {
    "run_and_output": lambda o: (
        o["result"] == o["output"] == 6 and o["status"] == "SUCCESSFUL" and o["listed"]
        and o["filtered"] == [] and o["missing"] == "KeyError"
        and o["meta"]["step_names"] == ["__output__", "step_0000", "step_0001"]),
    "resume_skips_completed": lambda o: (
        o["error"] is not None and o["failed"] == "FAILED" and o["resumed"] == 15
        and o["status"] == "SUCCESSFUL" and o["counted_step_runs"] == 1
        and o["steps_after_failure"] == ["step_0000", "step_0001"]),
    "run_async_and_output_async": lambda o: o == {"value": "done", "later": "done",
                                                  "missing": "KeyError"},
    "delete": lambda o: o == {"status": None, "listed": []},
    "wait_for_event_and_replay": lambda o: (
        o["out"] == o["replay"] == {"event": {"approved": True}, "base": 7}
        and o["waiters"] is False),
    "timer_listener_fires": lambda o: o == {"waited": True, "float": True,
                                            "abstract": "NotImplementedError"},
    "options_catch_and_no_checkpoint": lambda o: (
        o["caught"][0] is None and o["caught"][1] == "RayTaskError" and "boom 3" in o["caught"][2]
        and o["again"] == 8 and o["unchecked_runs"] == 2 and o["bad_key"] == "ValueError"),
    "cancel_and_resume": lambda o: (
        o["canceled"] == "CANCELED" and o["resumed"] == 2 and o["status"] == "SUCCESSFUL"
        and o["resume_unknown"] == "FileNotFoundError" and o["unknown_status"] is None),
    "sleep_step": lambda o: o == {"first": 0.1, "slept": True, "replay": 0.1},
    "http_event_trigger": lambda o: (
        o == {"value": "approved", "delivered": {"delivered": "release"},
              "refused_only_404": True}),
}


def test_every_scenario_is_checked():
    assert {fn.__name__[3:] for fn in SCENARIOS} == set(EXPECT)


@pytest.mark.parametrize("key", sorted(EXPECT))
def test_workflow_scenario_matches_jax(runs, key):
    j, p = runs["ray_tpu"][key], runs["ray_tpu_torch"][key]
    assert not (isinstance(p, tuple) and p[:1] == ("raised",)), p
    assert not (isinstance(j, tuple) and j[:1] == ("raised",)), j
    if key == "options_catch_and_no_checkpoint":
        # the caught error's text names each package's own traceback
        p = dict(p, caught=p["caught"][:2])
        j = dict(j, caught=j["caught"][:2])
    assert p == j
    assert EXPECT[key](runs["ray_tpu_torch"][key]), p


def test_default_storage_keeps_each_package_apart_in_one_process(tmp_path):
    """One workflow id, run by both packages in this process with their
    default storage: the bases differ, each package resumes from its own
    checkpoints only, and deleting one package's workflow leaves the
    other's."""
    sides = {name: _Side(name) for name in PACKAGES}
    bases = {name: s.storage.WorkflowStorage().base for name, s in sides.items()}
    assert bases["ray_tpu"] != bases["ray_tpu_torch"]
    assert os.path.basename(bases["ray_tpu_torch"]) == "ray_tpu_torch_workflows"
    wid = f"wf_same_{os.getpid()}_{time.monotonic_ns()}"
    outs = {}
    for name, s in sides.items():
        s.wf.init()
        s.rt.init(num_cpus=2)
        try:
            marker = str(tmp_path / f"{name}_fail")
            open(marker, "w").close()
            x = 1 if name == "ray_tpu" else 100
            dag = s.step(tasks._wf_fail_once).bind(s.step(tasks._wf_add).bind(x, x), marker)
            assert _raises(lambda: s.wf.run(dag, workflow_id=wid)) is not None
            outs[name] = s.wf.resume(wid)
        finally:
            s.rt.shutdown()
    assert outs == {"ray_tpu": 7, "ray_tpu_torch": 205}
    for name in PACKAGES:
        assert os.path.isdir(os.path.join(bases[name], wid))
    sides["ray_tpu"].wf.delete(wid)
    assert sides["ray_tpu_torch"].wf.get_output(wid) == 205
    sides["ray_tpu_torch"].wf.delete(wid)
    assert sides["ray_tpu"].wf.get_status(wid) is None
