"""TrainController: elastic gang-scheduled SPMD data-parallel training.

The port's copy of ``ray_tpu/train/controller.py``; what differs:

* state on the card: params and momentum are tensors on the controller's
  ``device`` (CUDA unless ``"cpu"`` is asked for), updated there; only a
  checkpoint (``_state``) moves them to numpy, so the files compare with the
  JAX package's leaf for leaf;
* the RNG key is the JAX package's ``jax.random.PRNGKey(seed)`` advanced by
  ``fold_in(key, step)``, computed by this module's own threefry-2x32 in
  numpy (bit for bit the same words);
* no jit: the member step is a plain autograd step, and ``step_fn`` counts
  the distinct shard shapes it has run — what the JAX trace cache counts;
* bit-exact replay on CUDA needs deterministic kernels: the caller sets
  ``torch.use_deterministic_algorithms(True)`` (and
  ``CUBLAS_WORKSPACE_CONFIG`` before CUDA starts) around the run and its
  replay; the controller never flips that process-wide switch itself;
* ``loss_fn(params, batch)`` takes the flat f32 params tensor and the
  member's batch tensor and returns the loss SUM over the batch's rows;
  ``param_init(seed)`` (optional) draws the initial flat params, so a model
  of any size can train through the gang (the default draws the JAX
  package's standard-normal probe head).

The composition layer over pieces that already exist —
``StageGroup`` gangs with typed BROKEN + ``repair()`` (dag/plan.py), the
drain path and crash-atomic snapshots (runtime/cluster.py, runtime/control.py),
admission arbitration (runtime/admission.py), the streaming Dataset executor
(data/executor.py) — and this controller wires them into one fault-tolerant
training job:

* the training stage is a **StageGroup gang** compiled into an
  ``ExecutionPlan``: one member step run per shard shape (the warmup
  primes each per-member shard shape exactly once), every optimizer step is
  one gang dispatch that splits the global batch across members and
  reassembles the packed ``[loss_sum, count, grad]`` rows;
* **bit-exact state**: params/momentum/step/RNG live on the controller, the
  member steps are stateless, and the update sums member rows in fixed
  member order inside one reduce — restoring a checkpoint and
  replaying the same (seed, step) batches reproduces the loss curve
  byte-for-byte (chaos invariant 12 audits exactly this);
* **repair-and-resume**: a gang-member death mid-step flips the plan BROKEN
  with the typed error; ``recover()`` restores the latest digest-framed
  checkpoint (train/checkpoint.py ``save_framed``), re-runs ``repair()``,
  and falls back to a shrink-rebuild when a member is permanently gone;
* **elastic resize**: ``resize()`` grows/shrinks the gang with zero lost
  step state (checkpoint first), re-tracing only at never-seen mesh sizes;
  scale-down drains a departing member's now-empty node through
  ``Cluster.drain_node`` (``node_drains_total{outcome=ok}``);
* **train-while-serve**: with ``train_preemptible`` the gang registers as a
  background admission source and ``preempt_member()`` implements the
  preemption contract (checkpoint -> shrink -> continue).

Batch determinism: ``global_batch(seed, step, ...)`` is a pure function —
world size changes WHERE the shard boundaries fall, never which rows are
drawn or their order, so an elastic resize continues the same data stream.
"""

from __future__ import annotations

import contextlib
import logging
import os
import pickle
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

_DTYPE = "float32"


# --------------------------------------------------------------------------
# threefry-2x32 (Salmon et al., SC'11), the JAX package's default PRNG: the
# key words of ``jax.random.PRNGKey`` and ``jax.random.fold_in``
# --------------------------------------------------------------------------
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key, x0: int, x1: int):
    """Threefry-2x32 with 20 rounds of the 32-bit words ``(x0, x1)`` under
    the key ``(k0, k1)``: the two output words (JAX's ``threefry2x32_p``)."""
    mask = 0xFFFFFFFF
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & mask, (x1 + ks[1]) & mask
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & mask
            x1 = ((x1 << r) | (x1 >> (32 - r))) & mask
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & mask
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & mask
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (threefry, 32-bit seeds): ``[0, seed]``
    as uint32 words."""
    return np.asarray([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the threefry hash of the words
    ``(0, data)`` under ``key``."""
    return np.asarray(_threefry2x32(key, 0, int(data) & 0xFFFFFFFF), dtype=np.uint32)


def global_batch(
    seed: int,
    step: int,
    *,
    batch_size: int,
    feature_dim: int = 0,
    rows: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The global batch for one optimizer step — a pure function of
    (seed, step).  With ``rows`` (a materialized ``[N, F]`` feature matrix,
    e.g. from the streaming Dataset executor) the batch draws row indices
    from the seeded stream; without it the features themselves are drawn.
    World size is deliberately NOT an input: resizing the gang re-shards
    the same batches, it never changes the data order."""
    rng = np.random.default_rng([int(seed), int(step)])
    if rows is not None:
        idx = rng.integers(0, rows.shape[0], size=batch_size)
        return np.ascontiguousarray(rows[idx], dtype=np.float32)
    return rng.standard_normal((batch_size, feature_dim), dtype=np.float32)


def _default_loss(params, batch):
    """Least-squares probe: predict each row's feature sum from a linear
    head.  Returns the SUM (not mean) of per-row losses so member-shard
    sums add to the global sum regardless of how the batch is sharded."""
    w = params[:-1]
    b = params[-1]
    pred = batch @ w + b
    target = torch.sum(batch, dim=1)
    return torch.sum((pred - target) ** 2)


class _MemberStep:
    """The stateless member step, counting the distinct shard shapes it has
    run: ``_cache_size()`` is what ``jax.jit``'s ``_cache_size()`` counts in
    the JAX package (one trace per per-member shard shape), so a resize to
    a never-seen gang size adds one and a revisited size none.  ``calls``
    counts every member step run (warm-ups and replays included)."""

    def __init__(self, fn: Callable):
        self._fn = fn
        self._lock = threading.Lock()
        self._shapes: set = set()
        self.calls = 0

    def __call__(self, params2d, batch):
        key = (tuple(params2d.shape), str(params2d.dtype), tuple(batch.shape), str(batch.dtype))
        with self._lock:
            self._shapes.add(key)
            self.calls += 1
        return self._fn(params2d, batch)

    def _cache_size(self) -> int:
        with self._lock:
            return len(self._shapes)


def _initial_params(seed: int, nparams: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed), 0xC0FFEE])
    return rng.standard_normal(nparams, dtype=np.float32)


class TrainController:
    """Drives one elastic gang-scheduled training job over a compiled plan.

    The recovery ladder (``recover()``):

    1. restore optimizer/step/RNG state from the latest digest-framed step
       checkpoint (torn files fall back to ``.prev``), truncating the loss
       history to the checkpoint step;
    2. ``plan.repair()`` — a restartable member comes back through the
       restart FSM and the SAME gang resumes (``train_repairs_total
       {outcome=repaired}``);
    3. a permanently-dead member (kill -9 past its restart budget, or a
       preemption) fails repair fast — the gang rebuilds at the largest
       legal size from fresh members (``outcome=shrunk``), bounded below by
       ``train_gang_min_members``; below the floor the typed error
       surfaces (``outcome=failed``).

    Every recovery appends an audit row to ``cluster.train_repair_audits``
    (restored state + accumulating post-repair losses + a bound replay
    callable); chaos invariant 12 replays each audit from its checkpoint
    and byte-compares the trajectories.
    """

    def __init__(
        self,
        name: str,
        *,
        world_size: int = 2,
        batch_size: int = 32,
        feature_dim: int = 8,
        seed: int = 0,
        learning_rate: float = 0.05,
        momentum: float = 0.9,
        loss_fn: Optional[Callable[[Any, Any], Any]] = None,
        dataset: Any = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_period: Optional[int] = None,
        min_members: Optional[int] = None,
        preemptible: Optional[bool] = None,
        repair_timeout: float = 30.0,
        member_resources: Optional[List[dict]] = None,
        device=None,
        param_init: Optional[Callable[[int], Any]] = None,
    ):
        import ray_tpu_torch
        from ray_tpu_torch.core.config import get_config
        from ray_tpu_torch.models.common import default_device

        cfg = get_config()
        if batch_size % world_size != 0:
            raise ValueError(
                f"batch_size {batch_size} must divide evenly across the "
                f"gang ({world_size} members)"
            )
        self.device = default_device(device, "TrainController")
        self.name = name
        self._batch_size = batch_size
        self._feature_dim = feature_dim
        self._seed = seed
        self._learning_rate = learning_rate
        self._momentum = momentum
        self._loss_fn = loss_fn or _default_loss
        self._param_init = param_init
        self._repair_timeout = repair_timeout
        self._member_resources = list(member_resources or [])
        self._checkpoint_period = (
            checkpoint_period
            if checkpoint_period is not None
            else cfg.train_checkpoint_period_steps
        )
        self._min_members = (
            min_members if min_members is not None else cfg.train_gang_min_members
        )
        self.preemptible = (
            preemptible if preemptible is not None else cfg.train_preemptible
        )
        self._checkpoint_dir = checkpoint_dir or tempfile.mkdtemp(
            prefix=f"rt_train_{name}_"
        )
        os.makedirs(self._checkpoint_dir, exist_ok=True)

        self._rows: Optional[np.ndarray] = None
        if dataset is not None:
            from ray_tpu_torch.data.executor import bundles_to_feature_rows

            self._rows = bundles_to_feature_rows(dataset._execute(preserve_order=True))
            self._feature_dim = int(self._rows.shape[1])
        self._nparams = self._feature_dim + 1

        self._lock = threading.RLock()
        # deterministic initial state — replayable from (seed) alone
        self._reset_state()

        # ONE member step per controller, counting its shard shapes: the
        # warmup primes each mesh size exactly once, revisited sizes add
        # none (tests assert _cache_size() stays flat)
        self.step_fn = _MemberStep(self._member_step)

        self._members: List[Any] = []
        self._plan = None
        self._last_checkpoint: Optional[str] = None
        self.resize_history: List[dict] = []
        self.repair_history: List[dict] = []
        self._open_audits: List[dict] = []

        self._cluster = ray_tpu_torch.get_cluster()
        self._admission_token: Optional[int] = None
        if self.preemptible:
            from ray_tpu_torch.runtime import admission

            self._admission_token = admission.register_admission_source(
                f"train:{name}", self._admission_snapshot
            )
        self._cluster.train_controllers[name] = self
        self._build_gang(world_size)

    def _reset_state(self) -> None:
        """The deterministic initial state of (seed): params from
        ``param_init`` or the standard-normal probe head, zero momentum, the
        seed's key, step 0."""
        if self._param_init is not None:
            init = torch.as_tensor(self._param_init(self._seed))
            self._nparams = int(init.numel())
        else:
            init = torch.from_numpy(_initial_params(self._seed, self._nparams))
        with self._lock:  # RLock: safe from locked and unlocked callers
            # a copy: the steps update it in place
            self._params = init.to(device=self.device, dtype=torch.float32,
                                   copy=True).reshape(-1)
            self._mom = torch.zeros_like(self._params)
            self._rng_key = prng_key(self._seed)
            self._step = 0
            self._loss_history: List[float] = []

    # ------------------------------------------------------------------
    # the math — everything that must be bit-exact lives here
    # ------------------------------------------------------------------
    def _member_step(self, params2d, batch):
        """Stateless per-member step: take this member's own leaf of the
        replicated ``[1, P]`` params row (the gang hands every member the
        SAME tensor, which no member may mark), value-and-grad of the loss
        SUM over this member's batch shard, and pack ``[loss_sum,
        row_count, grad]`` into one ``[1, P+2]`` row the gang assembly
        concatenates."""
        with torch.cuda.device(params2d.device) if params2d.is_cuda else contextlib.nullcontext():
            params = params2d[0].detach().requires_grad_()
            loss = self._loss_fn(params, batch)
            (grad,) = torch.autograd.grad(loss, params)
            row = torch.cat(
                [
                    loss.detach().reshape(1).to(params.dtype),
                    torch.full((1,), batch.shape[0], dtype=params.dtype, device=params.device),
                    grad,
                ]
            )
            return row[None, :]

    def _update(self, params, mom, rows):
        """One optimizer step from the assembled member rows.  The member
        sum is an explicit sequential reduce in member order — the float
        addition order is pinned by construction, so the same checkpoint
        plus the same batches reproduces the same bits.  ``params`` and
        ``mom`` are updated in place (the same roundings as the JAX
        package's ``momentum * mom + grad`` and ``params - lr * mom``), so
        a step allocates no second copy of either."""
        with torch.no_grad():
            total = rows[0]
            for i in range(1, rows.shape[0]):
                total = total + rows[i]
            loss_sum, count = total[0], total[1]
            grad = total[2:] / count
            mom.mul_(self._momentum).add_(grad)
            del grad
            params.sub_(mom * self._learning_rate)
            return params, mom, loss_sum / count

    def _device_batch(self, batch: np.ndarray):
        return torch.from_numpy(batch).to(self.device)

    # ------------------------------------------------------------------
    # gang lifecycle
    # ------------------------------------------------------------------
    def _legal_size(self, n: int) -> int:
        """Largest gang size <= n that divides the batch and respects the
        member floor; 0 when none exists."""
        for k in range(min(n, self._batch_size), 0, -1):
            if self._batch_size % k == 0 and k >= self._min_members:
                return k
        return 0

    # rt-lint: guarded-by(_lock) -- callers: _resize_locked/_recover_locked
    # hold it; __init__ runs pre-publication with exclusive access (stronger)
    def _build_gang(self, world_size: int, members: Optional[List[Any]] = None) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.dag import InputNode, StageGroup

        step_fn = self.step_fn

        @ray_tpu_torch.remote
        class _GangMember:
            def step(self, params2d, batch):
                return step_fn(params2d, batch)

        members = list(members or [])
        while len(members) > world_size:
            ray_tpu_torch.kill(members.pop(), no_restart=True)
        for i in range(len(members), world_size):
            opts: Dict[str, Any] = dict(execution="inproc", max_restarts=1)
            if self._member_resources:
                opts["resources"] = self._member_resources[
                    i % len(self._member_resources)
                ]
                opts["num_cpus"] = 0
            if self.device.type == "cuda" and "GPU" not in opts.get("resources", {}):
                # every member computes on the controller's card: the gang
                # holds that card, a 1/world_size share a member, rounded
                # down to the milli-units the scheduler counts in
                from ray_tpu_torch.core.resources import SCALE

                opts["num_gpus"] = (SCALE // world_size) / SCALE
            members.append(_GangMember.options(**opts).remote())
        self._members = members
        gang = StageGroup(
            members,
            "step",
            split_axis=0,
            warmup=[
                ((1, self._nparams), _DTYPE),
                ((self._batch_size, self._feature_dim), _DTYPE),
            ],
        )
        with InputNode() as inp:
            out = gang.bind(inp[0], inp[1])
        self._plan = out.compile_plan(name=f"train:{self.name}")

    # rt-lint: guarded-by(_lock) -- callers: _resize_locked/_recover_locked/
    # shutdown hold it
    def _teardown_plan(self) -> None:
        if self._plan is not None:
            try:
                self._plan.teardown()
            except Exception:  # noqa: BLE001 — a broken plan tears down best-effort
                pass
            self._plan = None

    def _member_node(self, member) -> Optional[Any]:
        info = self._cluster.control.actors.get(member._actor_id)
        return info.node_id if info is not None else None

    # rt-lint: guarded-by(_lock) -- caller: _recover_locked holds it
    def _alive_members(self) -> List[Any]:
        from ray_tpu_torch.runtime.control import ActorState

        alive = []
        for m in self._members:
            info = self._cluster.control.actors.get(m._actor_id)
            if info is not None and info.state is not ActorState.DEAD:
                alive.append(m)
        return alive

    # ------------------------------------------------------------------
    # the train loop
    # ------------------------------------------------------------------
    @property
    # rt-lint: disable=lock-discipline -- observability snapshot: a torn
    # read only skews a status line, never a training step
    def world_size(self) -> int:
        return len(self._members)

    @property
    # rt-lint: disable=lock-discipline -- observability snapshot: a torn
    # read only skews a status line, never a training step
    def step_count(self) -> int:
        return self._step

    # rt-lint: disable=lock-discipline -- observability snapshot: the list
    # copy tolerates a step landing concurrently
    def losses(self) -> List[float]:
        return list(self._loss_history)

    def step(self) -> float:
        """One optimizer step: one gang dispatch + one update."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> float:
        from ray_tpu_torch.observability import metric_defs

        batch = global_batch(
            self._seed,
            self._step,
            batch_size=self._batch_size,
            feature_dim=self._feature_dim,
            rows=self._rows,
        )
        rows = self._plan.execute(self._params[None, :], self._device_batch(batch))
        self._params, self._mom, loss = self._update(self._params, self._mom, rows)
        del rows
        # advance the RNG state so it is genuinely stateful (and therefore
        # genuinely restored): derive the next key from the current one
        self._rng_key = fold_in(self._rng_key, self._step)
        loss_val = float(np.float32(loss.item()))
        self._loss_history.append(loss_val)
        self._step += 1
        metric_defs.TRAIN_STEPS.inc()
        for audit in self._open_audits:
            audit["losses"].append(loss_val)
        if self._checkpoint_period and self._step % self._checkpoint_period == 0:
            self.save_checkpoint()
        return loss_val

    # rt-lint: disable=lock-discipline -- the loop bound reads _step
    # optimistically; every mutation happens inside step()/recover(),
    # which take the lock, so a torn read costs at most one extra
    # loop-condition check
    def run(self, num_steps: int, *, auto_repair: bool = True) -> List[float]:
        """Run ``num_steps`` steps with the recovery ladder armed: a typed
        gang failure mid-step triggers ``recover()`` and the loop resumes
        from the restored step (re-running steps lost since the last
        checkpoint).  ``auto_repair=False`` surfaces the typed error."""
        from ray_tpu_torch.exceptions import RayActorError, WorkerCrashedError

        target = self._step + num_steps
        while self._step < target:
            try:
                self.step()
            except (RayActorError, WorkerCrashedError) as exc:
                if not auto_repair:
                    raise
                self.recover(error=exc)
        return self.losses()

    # ------------------------------------------------------------------
    # checkpoint / restore — crash-atomic digest framing
    # ------------------------------------------------------------------
    def _state(self) -> Dict[str, Any]:
        with self._lock:  # RLock: safe from locked and unlocked callers
            return {
                "name": self.name,
                "step": self._step,
                "seed": self._seed,
                # host copies (never views of the live tensors, which the
                # steps update in place)
                "params": self._params.detach().to("cpu", copy=True).numpy(),
                "momentum": self._mom.detach().to("cpu", copy=True).numpy(),
                "rng_key": np.asarray(self._rng_key),
                "world_size": len(self._members),
                "loss_history": np.asarray(self._loss_history, dtype=np.float32),
            }

    def _apply_state(self, state: Dict[str, Any]) -> None:
        with self._lock:  # RLock: safe from locked and unlocked callers
            self._params = self._on_device(state["params"])
            self._mom = self._on_device(state["momentum"])
            self._rng_key = np.asarray(state["rng_key"]).copy()
            self._step = int(state["step"])
            self._loss_history = [
                float(x)
                for x in np.asarray(state["loss_history"], dtype=np.float32)
            ]

    def _on_device(self, host) -> "torch.Tensor":
        """A checkpoint's f32 leaf as a fresh tensor on the device."""
        arr = np.ascontiguousarray(np.asarray(host, dtype=np.float32))
        return torch.from_numpy(arr).to(self.device, copy=True)

    @property
    def checkpoint_path(self) -> str:
        return os.path.join(self._checkpoint_dir, "state.ckpt")

    @property
    def last_checkpoint(self) -> Optional[str]:
        return self._last_checkpoint

    def save_checkpoint(self) -> str:
        """Write the step state with the crash-atomic framing (tmp + fsync
        + rename + ``.prev`` rotation) and mirror a summary into the
        durable control KV so the job rides ``restart_head``."""
        from ray_tpu_torch.observability import metric_defs
        from ray_tpu_torch.train.checkpoint import save_framed

        t0 = time.perf_counter()
        path = self.checkpoint_path
        with self._lock:  # RLock: safe from locked and unlocked callers
            state = self._state()
            summary = {
                "name": self.name,
                "step": self._step,
                "checkpoint": path,
                "world_size": len(self._members),
                "seed": self._seed,
                "batch_size": self._batch_size,
                "feature_dim": self._feature_dim,
            }
        save_framed(path, state)
        self._last_checkpoint = path
        metric_defs.TRAIN_CHECKPOINT_SECONDS.observe(time.perf_counter() - t0)
        try:
            # head failover must not orphan the job: the claim summary
            # rides the control snapshot (restore_snapshot -> kv.restore)
            self._cluster.control.kv.put(
                f"train/{self.name}".encode(),
                pickle.dumps(summary, protocol=5),
            )
        except Exception:  # noqa: BLE001 — KV mirroring is best-effort
            logger.exception("train %s: control-KV checkpoint mirror failed", self.name)
        return path

    def restore(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Load the latest digest-valid checkpoint (falling back to
        ``.prev`` on a torn file) and install its state."""
        from ray_tpu_torch.train.checkpoint import load_framed

        state = load_framed(path or self.checkpoint_path)
        if state is None:
            raise FileNotFoundError(
                f"no readable train checkpoint at {path or self.checkpoint_path}"
            )
        self._apply_state(state)
        return state

    @classmethod
    def claim(cls, name: str, **overrides) -> "TrainController":
        """Claim an orphaned job after a head failover: the KV summary
        (restored by the head snapshot) names the checkpoint to resume
        from; a fresh controller restores it and continues bit-exactly."""
        import ray_tpu_torch

        cluster = ray_tpu_torch.get_cluster()
        raw = cluster.control.kv.get(f"train/{name}".encode())
        if raw is None:
            raise KeyError(f"no claimable train job {name!r} in the control KV")
        summary = pickle.loads(raw)
        kwargs = dict(
            world_size=summary["world_size"],
            seed=summary["seed"],
            batch_size=summary["batch_size"],
            feature_dim=summary["feature_dim"],
            checkpoint_dir=os.path.dirname(summary["checkpoint"]),
        )
        kwargs.update(overrides)
        ctl = cls(name, **kwargs)
        ctl.restore(summary["checkpoint"])
        return ctl

    # ------------------------------------------------------------------
    # recovery ladder
    # ------------------------------------------------------------------
    def recover(self, error: Optional[BaseException] = None, timeout: Optional[float] = None) -> str:
        with self._lock:
            return self._recover_locked(error, timeout or self._repair_timeout)

    def _recover_locked(self, error, timeout: float) -> str:
        from ray_tpu_torch.observability import metric_defs
        from ray_tpu_torch.train.checkpoint import load_framed

        # 1. restore the latest good checkpoint (or the deterministic
        #    initial state when none was written yet)
        state = load_framed(self.checkpoint_path)
        if state is not None:
            self._apply_state(state)
        else:
            self._reset_state()
            state = self._state()
        resume_step = self._step
        # earlier audits stop accumulating: their recorded prefix up to the
        # restored step is still a valid continuous trajectory
        for audit in self._open_audits:
            keep = max(0, resume_step - audit["start_step"])
            del audit["losses"][keep:]
            audit["open"] = False
        self._open_audits = []

        # 2. repair the SAME gang in place (restartable member death)
        outcome = "repaired"
        try:
            self._plan.repair(timeout=timeout)
        except Exception as repair_exc:  # noqa: BLE001 — ladder rung 3 below
            # 3. permanently-dead member: shrink-rebuild from fresh members
            alive = self._alive_members()
            new_size = self._legal_size(len(alive))
            if new_size <= 0:
                metric_defs.TRAIN_REPAIRS.inc(tags={"outcome": "failed"})
                self.repair_history.append(
                    {"step": resume_step, "outcome": "failed",
                     "error": type(error or repair_exc).__name__}
                )
                raise (error or repair_exc)
            self._teardown_plan()
            for m in self._members:
                try:
                    import ray_tpu_torch

                    ray_tpu_torch.kill(m, no_restart=True)
                except Exception:  # noqa: BLE001 — already-dead members
                    pass
            self._build_gang(new_size)
            outcome = "shrunk"
        metric_defs.TRAIN_REPAIRS.inc(tags={"outcome": outcome})
        self.repair_history.append(
            {
                "step": resume_step,
                "outcome": outcome,
                "world_size": len(self._members),
                "error": type(error).__name__ if error is not None else None,
            }
        )
        # invariant-12 audit: the restored state + the losses that follow
        # must equal an uninterrupted replay from the same state
        audit = {
            "controller": self.name,
            "start_step": resume_step,
            "world_size": len(self._members),
            "outcome": outcome,
            "state": state,
            "losses": [],
            "open": True,
            "replay": self.replay,
        }
        self._open_audits.append(audit)
        self._cluster.train_repair_audits.append(audit)
        return outcome

    def replay(self, state: Dict[str, Any], world_size: int, num_steps: int) -> List[float]:
        """Uninterrupted reference run: from ``state``, compute ``num_steps``
        losses at ``world_size`` WITHOUT the plan — same member step on the
        same shard shapes in the same member order, so the result is
        bit-identical to what the gang produced (chaos invariant 12; on
        CUDA under deterministic algorithms, as the gang ran)."""
        params = self._on_device(state["params"])
        mom = self._on_device(state["momentum"])
        step0 = int(state["step"])
        losses: List[float] = []
        for s in range(step0, step0 + num_steps):
            batch = global_batch(
                self._seed, s,
                batch_size=self._batch_size,
                feature_dim=self._feature_dim,
                rows=self._rows,
            )
            shards = np.split(batch, world_size, axis=0)
            outs = [self.step_fn(params[None, :], self._device_batch(sh)) for sh in shards]
            rows = outs[0] if world_size == 1 else torch.cat(outs, dim=0)
            del outs
            params, mom, loss = self._update(params, mom, rows)
            del rows
            losses.append(float(np.float32(loss.item())))
        return losses

    # ------------------------------------------------------------------
    # elasticity
    # ------------------------------------------------------------------
    def resize(self, new_size: int, *, reason: str = "scale_up") -> int:
        """Grow/shrink the gang with zero lost step state: checkpoint,
        rebuild the plan at the new size (keeping surviving members),
        drain a departing member's now-empty node.  Returns the new size."""
        with self._lock:
            return self._resize_locked(new_size, reason)

    def _resize_locked(self, new_size: int, reason: str) -> int:
        import ray_tpu_torch
        from ray_tpu_torch.observability import metric_defs

        old_size = len(self._members)
        new_size = self._legal_size(new_size)
        if new_size <= 0:
            raise ValueError(
                f"no legal gang size <= requested for batch {self._batch_size} "
                f"and floor {self._min_members}"
            )
        if new_size == old_size:
            return old_size
        # a resize changes the shard arithmetic, so the loss trajectory is
        # only comparable to a fixed-size replay up to this boundary: seal
        # any open repair audits (their recorded prefix stays valid)
        for audit in self._open_audits:
            audit["open"] = False
        self._open_audits = []
        self.save_checkpoint()  # zero lost step state across the rebuild
        self._teardown_plan()
        if new_size < old_size:
            departing = self._members[new_size:]
            keep = self._members[:new_size]
            keep_nodes = {self._member_node(m) for m in keep}
            head_id = getattr(self._cluster.head_node, "node_id", None)
            for m in departing:
                node_id = self._member_node(m)
                ray_tpu_torch.kill(m, no_restart=True)
                # the drain path: a departing member's node, once empty of
                # gang members (and not the head), drains gracefully —
                # sole-replica objects evacuate, node_drains_total{outcome=ok}
                if (
                    node_id is not None
                    and node_id not in keep_nodes
                    and node_id != head_id
                ):
                    try:
                        self._cluster.drain_node(node_id)
                    except Exception:  # noqa: BLE001 — drain is best-effort
                        logger.exception(
                            "train %s: drain of departing node failed", self.name
                        )
            self._build_gang(new_size, members=keep)
        elif self.device.type == "cuda":
            # the members hold 1/old_size of the card each: a grown gang
            # is built anew at 1/new_size (a member keeps no state)
            for m in self._members:
                ray_tpu_torch.kill(m, no_restart=True)
            self._build_gang(new_size)
        else:
            self._build_gang(new_size, members=list(self._members))
        metric_defs.TRAIN_GANG_RESIZES.inc(tags={"reason": reason})
        self.resize_history.append(
            {"step": self._step, "from": old_size, "to": new_size, "reason": reason}
        )
        return new_size

    def elastic_tick(self) -> int:
        """Autoscaler hook: reconcile the gang size against live capacity.
        Capacity = total CPU across alive, non-draining nodes; the gang
        absorbs spare capacity up to the largest legal size and shrinks
        when capacity left."""
        draining = getattr(self._cluster.cluster_scheduler, "is_draining", None)
        cpus = 0.0
        for node_id, node in list(self._cluster.nodes.items()):
            if node.dead:
                continue
            if draining is not None and draining(node_id):
                continue
            cpus += node.pool.total.to_dict().get("CPU", 0.0)
        desired = self._legal_size(max(1, int(cpus)))
        # rt-lint: disable=lock-discipline -- optimistic gate: the resize
        # re-checks plan state under the lock and no-ops on an equal size
        current = len(self._members)
        if desired and desired != current:
            reason = "scale_up" if desired > current else "scale_down"
            with self._lock:
                if self._plan is not None and self._plan.state == "READY":
                    return self._resize_locked(desired, reason)
        return current

    def preempt_member(self, index: Optional[int] = None, *, graceful: bool = True):
        """The preemption contract (train-while-serve): take one member
        away from the gang.  Graceful = checkpoint -> shrink -> continue
        (what a serving burst does through admission); non-graceful =
        hard-kill the member mid-step (chaos `preempt_gang_member`) — the
        next step surfaces the typed error and ``recover()`` shrinks."""
        import ray_tpu_torch

        if not self.preemptible:
            raise RuntimeError(
                f"train job {self.name!r} is not preemptible "
                "(train_preemptible=False)"
            )
        with self._lock:
            n = len(self._members)
            if graceful:
                return self._resize_locked(
                    self._legal_size(n - 1) or n, "preempt"
                )
            victim = self._members[index if index is not None else n - 1]
        ray_tpu_torch.kill(victim, no_restart=True)
        return n

    # rt-lint: disable=lock-discipline -- observability snapshot: torn
    # reads only skew a dashboard poll, never admission decisions
    def _admission_snapshot(self) -> dict:
        return {
            "kind": "train",
            "preemptible": True,
            "gang_size": len(self._members),
            "step": self._step,
        }

    # ------------------------------------------------------------------
    # observability / shutdown
    # ------------------------------------------------------------------
    # rt-lint: disable=lock-discipline -- observability snapshot (GET
    # /api/train, `rt train`): torn reads only skew one poll
    def status(self) -> dict:
        return {
            "name": self.name,
            "gang_size": len(self._members),
            "step": self._step,
            "seed": self._seed,
            "batch_size": self._batch_size,
            "preemptible": self.preemptible,
            "plan_state": self._plan.state if self._plan is not None else None,
            "last_checkpoint": self._last_checkpoint,
            "last_loss": self._loss_history[-1] if self._loss_history else None,
            "resizes": list(self.resize_history),
            "repairs": list(self.repair_history),
        }

    def shutdown(self) -> None:
        import ray_tpu_torch

        with self._lock:
            for audit in self._open_audits:
                audit["open"] = False
            self._open_audits = []
            self._teardown_plan()
            for m in self._members:
                try:
                    ray_tpu_torch.kill(m, no_restart=True)
                except Exception:  # noqa: BLE001
                    pass
            self._members = []
        if self._admission_token is not None:
            from ray_tpu_torch.runtime import admission

            admission.unregister_admission_source(self._admission_token)
            self._admission_token = None
        self._cluster.train_controllers.pop(self.name, None)
