"""joblib backend running Parallel() jobs as remote tasks.

The port's copy of ``ray_tpu/util/joblib.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``. The backend keeps the reference's name, ``"ray_tpu"``.

Parity: ``python/ray/util/joblib/`` — ``register_ray_tpu()`` then
``joblib.parallel_backend("ray_tpu")`` routes scikit-learn style
``Parallel(n_jobs=...)`` work through the task fabric. Implements the
modern joblib backend contract: ``submit`` returns a
``concurrent.futures.Future`` resolved by a waiter thread per in-flight
batch (joblib batches aggressively, so waiter count stays ~n_jobs).
"""

from __future__ import annotations

from concurrent.futures import Future


def register_ray_tpu() -> None:
    from joblib.parallel import register_parallel_backend

    register_parallel_backend("ray_tpu", _make_backend())


def _make_backend():
    from joblib._parallel_backends import ParallelBackendBase

    class RayTpuBackend(ParallelBackendBase):
        """Each joblib BatchedCalls runs as one remote task."""

        supports_retrieve_callback = True
        supports_timeout = True

        def effective_n_jobs(self, n_jobs):
            import ray_tpu_torch as rt

            if not rt.is_initialized():
                rt.init()
            if n_jobs == 1:
                return 1
            cpus = max(int(rt.cluster_resources().get("CPU", 1)), 1)
            if n_jobs is None:
                n_jobs = -1
            if n_jobs < 0:
                # joblib idiom: -1 = all cpus, -2 = all but one, ...
                return max(cpus + 1 + n_jobs, 1)
            return min(n_jobs, cpus)

        def configure(self, n_jobs=1, parallel=None, **backend_kwargs):
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

        def submit(self, func, callback=None):
            import threading

            import ray_tpu_torch as rt

            ref = rt.remote(lambda: func()).remote()
            future: Future = Future()

            def waiter():
                try:
                    future.set_result(rt.get(ref))
                except BaseException as exc:  # noqa: BLE001 — joblib re-raises
                    future.set_exception(exc)

            threading.Thread(target=waiter, daemon=True).start()
            if callback is not None:
                future.add_done_callback(callback)
            return future

        def retrieve_result_callback(self, future):
            return future.result()

        def terminate(self):
            pass

        def abort_everything(self, ensure_ready=True):
            if ensure_ready and self.parallel is not None:
                self.configure(n_jobs=self.parallel.n_jobs, parallel=self.parallel)

    return RayTpuBackend
