"""Node agent: joins a head over TCP and runs a full local node runtime.

``python -m ray_tpu_torch.runtime.agent --address=<head_host:port>`` (or
``rt start --address=...``) is the multi-host analogue of the reference's
``ray start --address`` raylet bring-up (``python/ray/scripts/scripts.py:568``
exec'ing ``src/ray/raylet/main.cc:123``): this process hosts a real
:class:`~ray_tpu_torch.runtime.node.Node` — local scheduler, process worker pool,
object-store tier, actor instances — and speaks to the head through one
duplex RPC connection.

The :class:`AgentFabric` implements the slice of the ``Cluster`` interface a
``Node`` calls (object pulls, task/stream/actor completion callbacks),
forwarding each across the wire; ordering holds because the transport
dispatches inbound messages on a single thread per connection.

The port's copy of ``ray_tpu/runtime/agent.py``.  Deltas: ``--num-gpus n``
registers the ``GPU`` resource (``accelerators/gpu.py``), and the agent
refuses to start when it sees fewer than ``n`` CUDA devices; without it the
agent registers no GPU and hides the card from its process and workers
(``CUDA_VISIBLE_DEVICES=""``), so it never creates a CUDA context.  A ``num_gpus`` actor
or task runs in this process, next to the card, as on the head; the process
workers stay hidden from the card unless they hold a GPU share.  The shm
arena (``/dev/shm/rttorch_a<pid>_<hex>``), its stale-segment reaper and the
session directory (``<tmp>/ray_tpu_torch_agent_<pid>``) are the port's own,
so neither package's agent can reap or reuse the other's.  A compiled
plan's stages on this agent are installed by the ``install_plan`` control
RPC (``runtime/channel_manager.install_remote_plan``) and released by
``uninstall_plan``, by shutdown and by self-fencing.
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch.core.ids import ActorID, NodeID, ObjectID, TaskID
from ray_tpu_torch.core.resources import ResourceSet
from ray_tpu_torch.runtime import rpc


class AgentFabric:
    """The Node's view of "the cluster" inside an agent process."""

    def __init__(self, session_dir: str):
        self.session_dir = session_dir
        self.conn: Optional[rpc.RpcConnection] = None
        self.node = None          # set after registration
        self.data_client = None   # peer-to-peer bulk transfer (data_plane)
        # incarnation granted by the head at registration: stamped on every
        # state-bearing frame this agent sends so the head can fence frames
        # from a superseded epoch (gray-failure split-brain guard)
        self.incarnation = 0
        self._pull_pool = None    # lazily-built transfer thread pool
        self._specs: Dict[bytes, Any] = {}   # task_id -> agent-side spec
        self._specs_lock = threading.Lock()
        # recently-completed pushed tasks: dedup window for the owner's
        # control-plane fallback resubmit racing a push whose delivery ack
        # was lost in flight (the task ran here; running it again would
        # break exactly-once side effects)
        self._pushed_done: "OrderedDict[Tuple[bytes, int], None]" = OrderedDict()
        # batched ObjectDirectory commits: per-put object_location notices
        # coalesce into one object_locations control RPC (flush on count or
        # a short deadline) — the head sees O(batches), not O(puts).  One
        # long-lived flusher thread parks on the condition: a Timer per
        # window would create+destroy an OS thread every few ms on the very
        # put path this batching exists to speed up
        self._loc_buf: list = []
        self._loc_cond = threading.Condition()
        self._loc_deadline: Optional[float] = None
        self._loc_thread: Optional[threading.Thread] = None

    def _transfer_pool(self):
        if self._pull_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            from ray_tpu_torch.core.config import get_config

            self._pull_pool = ThreadPoolExecutor(
                max_workers=max(1, get_config().max_concurrent_object_transfers),
                thread_name_prefix="agent-pull",
            )
        return self._pull_pool

    # -- object movement ----------------------------------------------------
    def pull_object(self, oid: ObjectID, node, callback) -> None:
        """Dependency pull.  The head is consulted for *metadata only*
        (``locate_object`` resolves the ObjectID to a peer's data address);
        the bytes then move peer-to-peer on the chunked data plane — never
        relayed through the head (reference: node-to-node Push/Pull,
        object_manager.h:117).  Falls back to the head-relay path when the
        data plane can't serve (peer died mid-transfer, no data address)."""
        if node.store.contains(oid):
            callback()
            return

        def relay():
            # head-relay fallback: correct under every failure mode (the
            # head re-resolves, recovers via lineage, tombstones lost
            # objects), at the cost of shipping bytes through the head.
            def on_reply(reply, error):
                if error is not None:
                    # Head gone: the process is about to exit via
                    # on_disconnect; leave the waiter.
                    return
                value, is_error = rpc.decode_value(reply)
                node.store.put(oid, value, is_error=is_error)
                callback()

            self.conn.request_async("pull_object", {"oid": oid.binary()}, on_reply)

        if self.data_client is None:
            relay()
            return
        # one re-locate after a failed peer: the failure notice purges the
        # stale location at the head, so the retry lands on a SURVIVING
        # replica (purge-then-retry parity with the head PullManager; this
        # is how a dead relay's chained children re-parent mid-broadcast)
        self._locate_and_pull(oid, node, callback, relay, retries=1)

    def _locate_and_pull(self, oid: ObjectID, node, callback, relay, retries: int) -> None:
        def on_locate(reply, error):
            if isinstance(error, rpc.RemoteHandlerError):
                # live head, failing handler (e.g. version skew): the relay
                # path can still serve — only connection loss strands us
                relay()
                return
            if error is not None:
                return  # head gone; process exiting
            addr = reply.get("addr")
            if addr == "self":
                # a push to this node is already in flight — wait for it
                self._transfer_pool().submit(self._wait_local, oid, node, callback, relay)
            elif addr:
                if retries > 0:
                    def fallback():
                        self._locate_and_pull(oid, node, callback, relay, retries - 1)
                else:
                    fallback = relay
                self._transfer_pool().submit(
                    self._direct_pull, addr, oid, node, callback, fallback
                )
            else:
                relay()

        self.conn.request_async("locate_object", {"oid": oid.binary()}, on_locate)

    def _wait_local(self, oid: ObjectID, node, callback, fallback) -> None:
        try:
            node.store.get(oid, timeout=30)
            callback()
        except Exception:  # noqa: BLE001
            fallback()

    def _direct_pull(self, addr: str, oid: ObjectID, node, callback, fallback) -> None:
        try:
            value, is_error = self.data_client.pull(addr, oid.binary(), timeout=30.0)
        except Exception:  # noqa: BLE001 — peer died / stale location
            # tell the head WHICH peer failed so it can purge the stale
            # location before this (or any other) consumer re-resolves
            try:
                self.conn.send("pull_failed", {"oid": oid.binary(), "addr": addr})
            except rpc.RpcError:
                pass
            fallback()
            return
        node.store.put(oid, value, is_error=is_error)
        # metadata-only notice: the head's directory records this node as a
        # location so future consumers can pull from here and recovery knows
        # this copy exists (device flag keeps HBM-residency tracking honest);
        # batched — it rides the next coalesced object_locations frame
        from ray_tpu_torch.core.object_store import _is_device_array as is_device_array

        from ray_tpu_torch.runtime.remote_node import _probe_nbytes

        self.notify_location(oid, _probe_nbytes(value)[0], is_device_array(value))
        callback()

    # -- completion callbacks (forwarded to the owner on the head) ----------
    def _drained_spans(self) -> list:
        """Finished tracing spans buffered on this agent (it has no sink):
        piggyback them on the next task_finished so they reach the head's
        span store.  Spans carry their trace ids, so draining everything
        accumulated — including spans of OTHER tasks on this agent — is
        attribution-safe."""
        from ray_tpu_torch.observability import tracing

        return tracing.drain_span_events()

    # -- batched directory commits --------------------------------------
    def notify_location(self, oid: ObjectID, size: int, device: bool) -> None:
        """Queue a location notice for the next coalesced object_locations
        RPC.  Flush on count, else on a short timer — one control frame per
        BATCH of puts instead of one per put (the multi_client_put row's
        head round-trips)."""
        from ray_tpu_torch.core.config import get_config

        cfg = get_config()
        entry = (oid.binary(), int(size or 0), bool(device))
        flush = None
        with self._loc_cond:
            self._loc_buf.append(entry)
            if len(self._loc_buf) >= max(1, cfg.location_commit_flush_count):
                flush, self._loc_buf = self._loc_buf, []
                self._loc_deadline = None
            else:
                if self._loc_deadline is None:
                    self._loc_deadline = time.monotonic() + max(
                        0.0, cfg.location_commit_flush_delay_s
                    )
                    self._loc_cond.notify()
                if self._loc_thread is None:
                    self._loc_thread = threading.Thread(
                        target=self._loc_flush_loop, name="loc-flush", daemon=True
                    )
                    self._loc_thread.start()
        if flush is not None:
            self._send_locations(flush)

    def _loc_flush_loop(self) -> None:
        while True:
            with self._loc_cond:
                while self._loc_deadline is None:
                    self._loc_cond.wait()
                delay = self._loc_deadline - time.monotonic()
                if delay > 0:
                    self._loc_cond.wait(delay)
                    continue  # re-check: a count-flush may have drained us
                flush, self._loc_buf = self._loc_buf, []
                self._loc_deadline = None
            if flush:
                self._send_locations(flush)

    def flush_locations(self) -> None:
        with self._loc_cond:
            flush, self._loc_buf = self._loc_buf, []
            self._loc_deadline = None
        if flush:
            self._send_locations(flush)

    def _stamp(self, payload: dict) -> dict:
        """Stamp the current incarnation onto a state-bearing frame."""
        payload["inc"] = self.incarnation
        return payload

    def reset_epoch(self) -> None:
        """Self-fence support: drop every remnant of the fenced epoch —
        remembered task specs (their tasks were resubmitted elsewhere; a
        stale entry would make the producing-here wait in _local_get stall
        30s on a result that will never commit), the pushed-task dedup
        window, and buffered location notices for the dropped store."""
        with self._specs_lock:
            self._specs.clear()
            self._pushed_done.clear()
        with self._loc_cond:
            self._loc_buf.clear()
            self._loc_deadline = None

    def _send_locations(self, locs: list) -> None:
        try:
            self.conn.send("object_locations", self._stamp({"locs": locs}))
        except rpc.RpcError:
            pass  # head gone: the rejoin/death path owns recovery

    def on_task_finished(self, node, spec, result, error) -> None:
        push = spec._push_reply
        if push is not None:
            # Leased direct dispatch: the OWNER is blocked on the data-plane
            # connection this task arrived on — route the completion back
            # there (owner-to-owner results; the head control channel never
            # sees this task again).  Returns still store locally first:
            # this node stays a valid object location either way.
            with self._specs_lock:
                self._pushed_done[(spec.task_id.binary(), spec.attempt)] = None
                while len(self._pushed_done) > 4096:
                    self._pushed_done.popitem(last=False)
            self._forget(spec)
            box, done = push
            if error is None and spec.num_returns != 0:
                if spec.num_returns == 1:
                    values = [result]
                else:
                    values = list(result) if result is not None else [None] * spec.num_returns
                for oid, value in zip(spec.return_ids, values):
                    node.store.put(oid, value)
                box["values"] = values
            box["result"] = result
            box["error"] = error
            done.set()
            return
        self._forget(spec)
        if error is not None:
            self._send_task_finished(spec, [], None, error)
            return
        # Store returns locally first: this node IS a valid object location
        # (the head's directory will record it), so same-node consumers read
        # without a wire round trip.
        if spec.num_returns == 1:
            values = [result]
        elif spec.num_returns == 0:
            values = []
        else:
            values = list(result) if result is not None else [None] * spec.num_returns
        for oid, value in zip(spec.return_ids, values):
            node.store.put(oid, value)
        self._send_task_finished(spec, values, result, None)

    def pushed_duplicate(self, task_bin: bytes, attempt: int) -> bool:
        """True when a control-plane submit duplicates a pushed task that is
        in flight or recently completed here — the owner's fallback resubmit
        raced a push whose delivery ack it never read.  That copy's
        completion is guaranteed to reach the owner (data-plane reply or the
        control re-route), so the duplicate must not run."""
        with self._specs_lock:
            if (task_bin, attempt) in self._pushed_done:
                return True
            prior = self._specs.get(task_bin)
        return (
            prior is not None
            and getattr(prior, "_push_reply", None) is not None
            and prior.attempt == attempt
        )

    def _send_task_finished(self, spec, values, result, error) -> None:
        """Control-plane completion notice (error / lazy / inline value).
        Returns must already be stored locally."""
        if error is not None:
            self.conn.send(
                "task_finished",
                self._stamp({"task_id": spec.task_id.binary(), "error": rpc.encode_value(error), "value": None,
                 "spans": self._drained_spans()}),
            )
            return
        from ray_tpu_torch.core.config import get_config

        threshold = get_config().data_plane_inline_bytes

        def lazy_commit() -> None:
            # LAZY commit: bulk results stay here; the completion notice is
            # metadata-only and consumers pull the bytes peer-to-peer on
            # demand.  The control connection never carries bulk frames.
            # Device placement of each return rides along so the head's
            # directory records HBM residency (SURVEY §5.8).
            from ray_tpu_torch.core.object_store import _is_device_array as is_device_array
            from ray_tpu_torch.runtime.remote_node import _probe_nbytes

            self.conn.send(
                "task_finished",
                self._stamp({
                    "task_id": spec.task_id.binary(), "value": None, "error": None,
                    "lazy": True,
                    "device_returns": [is_device_array(v) for v in values],
                    # per-return sizes: the head's directory needs them for
                    # locality scoring + pull admission without the bytes
                    "return_sizes": [_probe_nbytes(v)[0] for v in values],
                    "spans": self._drained_spans(),
                }),
            )

        if self.data_client is not None:
            # out-of-band size probe (no GIL-held in-band pickle of bulk
            # values, even nested in containers)
            from ray_tpu_torch.runtime.remote_node import _bulk_size

            if _bulk_size(result) > threshold:
                lazy_commit()
                return
        enc = rpc.encode_value(result)
        if self.data_client is not None and len(enc["value_blob"]) > threshold:
            lazy_commit()
            return
        self.conn.send(
            "task_finished",
            self._stamp({"task_id": spec.task_id.binary(), "value": enc, "error": None,
             "spans": self._drained_spans()}),
        )

    def on_stream_item(self, node, spec, index: int, value, is_error: bool = False) -> None:
        enc = None
        if not is_error and self.data_client is not None:
            from ray_tpu_torch.core.config import get_config
            from ray_tpu_torch.core.ids import ObjectID as _OID
            from ray_tpu_torch.runtime.remote_node import _probe_nbytes

            threshold = get_config().data_plane_inline_bytes
            # cheap metadata probe; unknown types encode ONCE and route on
            # the encoded size (this is a per-item hot path — never pickle
            # twice)
            approx, fully_known = _probe_nbytes(value)
            bulk = approx > threshold
            if not fully_known and not bulk:
                enc = rpc.encode_value(value, is_error)
                bulk = len(enc["value_blob"]) > threshold
            if bulk:
                # bulk stream item (shuffle blocks, batches): store locally
                # under its deterministic item oid and send metadata only —
                # consumers pull peer-to-peer on demand
                from ray_tpu_torch.core.object_store import _is_device_array as is_device_array

                oid = _OID.for_task_return(spec.task_id, index + 1)
                node.store.put(oid, value)
                self.conn.send(
                    "stream_item",
                    self._stamp({
                        "task_id": spec.task_id.binary(), "index": index,
                        "lazy": True, "device": is_device_array(value),
                        "size": approx,
                    }),
                )
                return
        self.conn.send(
            "stream_item",
            self._stamp({
                "task_id": spec.task_id.binary(), "index": index,
                "value": enc if enc is not None else rpc.encode_value(value, is_error),
            }),
        )

    def on_stream_done(self, node, spec, index: int, error) -> None:
        self._forget(spec)
        self.conn.send(
            "stream_done",
            self._stamp({
                "task_id": spec.task_id.binary(),
                "index": index,
                "error": rpc.encode_value(error) if error is not None else None,
            }),
        )

    # -- actor lifecycle ----------------------------------------------------
    def on_actor_created(self, node, spec) -> None:
        self._forget(spec)
        self.conn.send("actor_created", self._stamp({"task_id": spec.task_id.binary()}))

    def on_actor_creation_failed(self, spec, error) -> None:
        self._forget(spec)
        self.conn.send(
            "actor_creation_failed",
            self._stamp({"task_id": spec.task_id.binary(), "error": rpc.encode_value(error)}),
        )

    def on_actor_process_died(self, node, actor_id: ActorID) -> None:
        self.conn.send("actor_died", self._stamp({"actor_id": actor_id.binary()}))

    def on_worker_process_died(self, pid) -> None:
        """Relay to the head, which keys this agent's worker pins by
        (agent node id, pid) — see remote_node._h_worker_api."""
        try:
            self.conn.send("worker_died", {"pid": pid})
        except Exception:  # noqa: BLE001 — head gone: its death sweep cleans up
            pass

    def handle_worker_api(
        self, blob: bytes, op: str = "", worker_key=None, pushed: bool = False
    ) -> bytes:
        """A worker on this agent made a nested API call: the owner (the
        driver's CoreWorker) lives across the transport — relay and wait.
        Long timeout: a nested get legitimately waits on real work.

        Fast path: a nested ``get`` whose objects already sit in THIS
        node's store (same-node task results, lazily-committed bulk) is
        answered locally — without it every byte round-trips the head's
        control connection twice (worker→agent→head→agent→worker).
        ``op`` rides beside the blob so only the ops with a local fast path
        (get/put) are ever deserialized here; everything else relays as an
        opaque blob.  ``pushed``: the calling worker is executing a task
        that arrived over the data-plane push channel — its result will NOT
        ride this control connection, so any ref the call mints must be
        registered synchronously (nothing orders the two channels)."""
        from ray_tpu_torch.runtime.worker_api import ASYNC_OPS

        if op in ASYNC_OPS:
            if op == "put_async":
                # keep the BYTES in this node's store; the head records
                # ownership + placement from the register notice
                try:
                    if self._local_put_async(blob, worker_key, sync=pushed):
                        return b""
                except Exception:  # noqa: BLE001 — fall through to full relay
                    pass
                # relay fallback must resolve shm markers HERE — the head
                # cannot read this host's arena
                shm = getattr(getattr(self.node, "store", None), "_shm", None)
                if shm is not None:
                    import pickle as _pickle

                    from ray_tpu_torch.runtime import protocol as _protocol

                    blob = _pickle.dumps(
                        _protocol.decode_put_frame(blob, shm), protocol=5
                    )
            # fire-and-forget: relay as a notification — the control
            # connection preserves order, the head processes inline
            self.conn.send(
                "worker_api_async",
                self._stamp({"blob": blob, "op": op, "worker_key": worker_key}),
            )
            return b""
        if op == "get":
            try:
                local = self._local_get(blob)
            except Exception:  # noqa: BLE001 — any surprise: authoritative path
                local = None
            if local is not None:
                return local
        elif op == "put":
            shm = getattr(self.node, "store", None) if self.node is not None else None
            shm = getattr(shm, "_shm", None)
            decoded = None
            if shm is not None:
                # resolve shm markers HERE: the arena is this host's — the
                # driver across the relay could never read them.  Keep the
                # DECODED frame: re-pickling the resolved bulk value just to
                # load it again would copy it twice.
                from ray_tpu_torch.runtime import protocol as _protocol

                decoded = _protocol.decode_put_frame(blob, shm)
            try:
                local = self._local_put(blob, decoded=decoded)
            except Exception:  # noqa: BLE001
                local = None
            if local is not None:
                return local
            if decoded is not None:
                # relay fallback needs an in-band blob the driver can read
                import pickle as _pickle

                blob = _pickle.dumps(decoded, protocol=5)
        # deadline-bearing in-proc tasks relay on THEIR OWN thread, so the
        # deadline context is visible here: pass the remaining budget
        # instead of the flat 24h bound (process-worker relays run on
        # worker-api threads with no context and keep the long default)
        reply = rpc.request_with_budget(
            self.conn, "worker_api",
            self._stamp({"blob": blob, "worker_key": worker_key}),
            default_timeout=24 * 3600.0,
        )
        return reply["blob"]

    def _local_put_async(self, blob: bytes, worker_key, sync: bool = False) -> bool:
        """Worker-minted fire-and-forget put: bytes stay in this node's
        store; the head gets a tiny ownership+pin notice.  Returns False
        when the value must rebuild in the driver (nested refs).  ``sync``
        (puts from PUSHED tasks): register with a blocking round trip — the
        minted ref travels back on the data-plane reply, which nothing
        orders against this control channel, so registration must complete
        before the put returns to the worker."""
        import pickle

        from ray_tpu_torch.core.ids import ObjectID as _OID
        from ray_tpu_torch.runtime import worker_api
        from ray_tpu_torch.runtime import protocol as _protocol

        shm = getattr(getattr(self.node, "store", None), "_shm", None)
        if shm is not None:
            _op, kw = _protocol.decode_put_frame(blob, shm)
        else:
            _op, kw = pickle.loads(blob)
        value = kw["value"]
        if not _ref_free(value):
            return False
        oid = _OID(kw["oid"])
        self.node.store.put(oid, value)
        from ray_tpu_torch.core.object_store import _is_device_array as is_device_array
        from ray_tpu_torch.runtime.remote_node import _probe_nbytes

        # placement rides INSIDE the ownership notice (one frame per put,
        # not two) — a separate batched object_locations frame could trail
        # the ownership record, and a node dying in that window left an
        # owned object the death/drain sweeps couldn't see (get hangs
        # instead of raising lost-object)
        reg_blob = worker_api._dumps((
            "register_put_async",
            {"oid": kw["oid"], "size": _probe_nbytes(value)[0],
             "device": is_device_array(value)},
        ))
        if sync:
            self.conn.request(
                "worker_api",
                self._stamp({"blob": reg_blob, "worker_key": worker_key}),
                timeout=30.0,
            )
        else:
            self.conn.send(
                "worker_api_async",
                self._stamp({"blob": reg_blob, "op": "register_put_async",
                 "worker_key": worker_key}),
            )
        return True

    def _local_put(self, blob: bytes, decoded=None) -> Optional[bytes]:
        """Nested put: the BYTES stay in this node's store; the head only
        mints the ObjectID and records ownership + location (metadata).
        Without this a worker's rt.put shipped the whole value over two
        control hops to live in the head's store.  Values that may carry
        nested ObjectRefs fall back (the relay path rebuilds them in the
        driver where the reference counter lives)."""
        import pickle

        from ray_tpu_torch.core.ids import ObjectID as _OID
        from ray_tpu_torch.runtime import worker_api

        _op, kw = pickle.loads(blob) if decoded is None else decoded
        value = kw["value"]
        if not _ref_free(value):
            return None
        reply = self.conn.request("mint_put_oid", self._stamp({}), timeout=30.0)
        oid = _OID(reply["oid"])
        try:
            self.node.store.put(oid, value)
            from ray_tpu_torch.core.object_store import _is_device_array as is_device_array
            from ray_tpu_torch.runtime.remote_node import _probe_nbytes

            self.notify_location(oid, _probe_nbytes(value)[0], is_device_array(value))
            # sync flush: the worker's put must not return before the head
            # can see the location (this path already pays a mint_put_oid
            # round trip, so the one-way frame is noise); replica notices
            # from _direct_pull stay batched — losing one loses a replica
            # RECORD, never the object
            self.flush_locations()
        except BaseException:
            # minted but not committed: unpin on the head and drop the local
            # copy, else the oid stays owned forever with a stranded value
            self.node.store.delete(oid)
            try:
                self.conn.send("release_put_oid", {"oid": oid.binary()})
            except Exception:  # noqa: BLE001 — conn death: head cleanup owns it
                pass
            raise
        from ray_tpu_torch.core.object_ref import ObjectRef

        return worker_api._dumps(("ok", ObjectRef(oid, _add_ref=False)))

    def _local_get(self, blob: bytes) -> Optional[bytes]:
        """Serve a nested get from the local store, or None to fall back.
        Only values free of nested ObjectRefs qualify (ref-bearing results
        need the driver's borrower/pinning bookkeeping)."""
        import pickle

        from ray_tpu_torch.core.object_ref import ObjectRef
        from ray_tpu_torch.runtime import worker_api

        _op, kw = pickle.loads(blob)
        refs = kw["refs"]
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        store = self.node.store
        values = []
        for r in ref_list:
            oid = r.id()
            if not store.contains(oid):
                # the producing task may be IN FLIGHT on this very node (a
                # nested get racing its producer — common when both ride
                # concurrent leased pushes): its returns commit locally
                # first, so wait for that commit instead of falling back to
                # the head relay, which would round-trip the bulk value
                # through the control plane for nothing
                task_bin = oid.task_id().binary()
                with self._specs_lock:
                    producing_here = task_bin in self._specs
                if not producing_here:
                    return None
                # bounded incremental wait, re-checking the producer is
                # STILL here each step: a producer that fails (its error
                # object commits at the owner, never locally) or migrates
                # must fall back to the head relay promptly, not after a
                # flat 30s.  Blocking is safe: sync gets are served on a
                # dedicated worker-api thread, never the pool reader.
                deadline = time.monotonic() + 30.0
                while True:
                    try:
                        store.get(oid, timeout=0.2)
                        break
                    except Exception:  # noqa: BLE001 — not committed yet
                        with self._specs_lock:
                            still_here = task_bin in self._specs
                        if not still_here and not store.contains(oid):
                            return None  # producer finished/failed elsewhere
                        if time.monotonic() >= deadline:
                            return None  # head relay is the authoritative path
            # short timeout: a concurrent free between contains() and get()
            # leaves an unwoken waiter — time out and take the head path
            value = store.get(oid, timeout=1.0)
            info = store.entry_info(oid)
            if info and info["is_error"] and isinstance(value, BaseException):
                return worker_api._dumps(("err", value))
            if not _ref_free(value):
                return None
            values.append(value)
        return worker_api._dumps(("ok", values[0] if single else values))

    # -- spec registry (cancellation) ---------------------------------------
    def _remember(self, spec) -> None:
        with self._specs_lock:
            self._specs[spec.task_id.binary()] = spec

    def _forget(self, spec) -> None:
        with self._specs_lock:
            self._specs.pop(spec.task_id.binary(), None)

    def lookup_spec(self, task_bin: bytes):
        with self._specs_lock:
            return self._specs.get(task_bin)


class NodeAgent:
    """Process-level wiring: connect, register, serve until disconnect."""

    def __init__(
        self,
        address: str,
        resources: Dict[str, float],
        labels: Optional[dict] = None,
        session_dir: Optional[str] = None,
    ):
        self.head_address = address
        self.resources = resources
        self.labels = labels or {}
        self.session_dir = session_dir or os.path.join(
            tempfile.gettempdir(), f"ray_tpu_torch_agent_{os.getpid()}"
        )
        os.makedirs(self.session_dir, exist_ok=True)
        self.fabric = AgentFabric(self.session_dir)
        self._fn_cache: Dict[bytes, Any] = {}
        self._stop = threading.Event()
        self._reconnect_lock = threading.Lock()
        self._reconnecting = False
        self._refencing = False
        self.node = None
        self.node_id: Optional[NodeID] = None
        self.conn: Optional[rpc.RpcConnection] = None
        self.incarnation = 0

    # ------------------------------------------------------------------
    def _install_inproc_api(self) -> None:
        """In-proc tasks execute in THIS process.  Without a global worker,
        ``rt.put``/``get``/``submit`` inside one would auto-init a phantom
        PRIVATE cluster whose refs mean nothing to the real head — puts
        silently landed in a runtime nobody else can see.  Install a
        WorkerApiClient whose transport is a direct call into the node's
        API handler: the exact frames process workers send over the pool
        socket, minus the socket.  Async ops run inline (put-before-result
        ordering, mirroring the pool's reader thread); sync ops compute
        their reply before ``send_request`` returns, so the caller's future
        resolves immediately."""
        import pickle as _pickle

        from ray_tpu_torch.core.object_ref import hooks
        from ray_tpu_torch.runtime.context import task_context
        from ray_tpu_torch.runtime.worker import set_global_worker
        from ray_tpu_torch.runtime.worker_api import ASYNC_OPS, WorkerApiClient
        from ray_tpu_torch.runtime.worker_main import _WorkerRefCounter

        wkey = os.getpid()

        def send_request(rid: int, blob: bytes, task_bin, op: str) -> None:
            node = self.node
            if op in ASYNC_OPS:
                try:
                    node._handle_worker_api(task_bin, blob, op=op, worker_key=wkey)
                except Exception:  # noqa: BLE001 — notification: no reply due
                    pass
                return
            try:
                reply = node._handle_worker_api(task_bin, blob, op=op, worker_key=wkey)
            except BaseException as exc:  # noqa: BLE001
                reply = _pickle.dumps(
                    ("err", RuntimeError(f"worker api failed: {exc}"))
                )
            client.on_reply(rid, reply)

        def current_task():
            cur = task_context.current()
            return cur[0].binary() if cur is not None else None

        client = WorkerApiClient(send_request, current_task)
        set_global_worker(client)
        # release protocol parity with process workers: refs minted by
        # in-proc tasks drop their owner-side pins when they go out of scope
        hooks.ref_counter = _WorkerRefCounter(client)

    def start(self) -> None:
        self.conn = rpc.connect(
            self.head_address,
            handlers=self._handlers(),
            on_disconnect=self._on_disconnect,
            name="agent",
        )
        self.fabric.conn = self.conn
        # Node id is generated HERE and the Node is fully constructed before
        # registration: the head may dispatch the instant it learns about
        # this node, so registration must be the last step.
        self.node_id = NodeID.from_random()
        reply = self.conn.request("register_node_config", {})
        self._check_protocol(reply)
        self._adopt_config(reply)
        from ray_tpu_torch.core.config import get_config

        cfg = get_config()
        # Native shm arena (plasma role) for THIS node's process workers:
        # without it every bulk worker result pays an in-band pickle over
        # the worker socket before it can even reach the data plane.
        self.shm_store = None
        try:
            from ray_tpu_torch.native.shm_store import ShmObjectStore

            # a kill -9'd agent can't unlink its segment: reap predecessors
            # whose embedded pid is dead before creating ours
            _gc_stale_shm_segments()
            # random suffix: pid reuse must not reopen a crashed agent's
            # stale segment; unlinked in shutdown()
            self.shm_store = ShmObjectStore(agent_segment_name(), 2 << 30)
        except Exception:  # noqa: BLE001 — no /dev/shm: plain pipes still work
            self.shm_store = None
        self.fabric.data_client = None  # built in _build_node_runtime
        # worker prints on this node surface on the DRIVER's stderr
        # (log_monitor parity; head side: HeadService._h_log_batch).
        # Batched: chatty workers must not serialize one RPC frame per line
        # against task traffic on the shared connection.
        # rt-lint: disable=lock-discipline -- start() setup: initialized
        # before _build_node_runtime spawns any thread that can log
        self._log_buf: list = []
        self._log_lock = threading.Lock()
        self._log_last_flush = time.monotonic()  # rt-lint: disable=lock-discipline -- start() setup
        self._build_node_runtime(self.conn)
        # rt.* must work inside in-proc tasks executing in THIS process
        # (auto-tier profiling routes hot small tasks here)
        self._install_inproc_api()
        # collectives / gang rendezvous in this process reach the cluster KV
        # over the head connection
        from ray_tpu_torch.runtime.kv_client import register_agent_kv

        register_agent_kv(self.conn)
        # stragglers below the batch threshold drain on the report tick
        # (_report_loop calls _flush_logs)
        reply = self._register(rejoin=False)
        self._adopt_incarnation(reply)
        self._report_thread = threading.Thread(
            target=self._report_loop, args=(self.conn,), name="agent-report", daemon=True
        )
        self._report_thread.start()

    def _build_node_runtime(self, conn: rpc.RpcConnection) -> None:
        """Construct the node-level runtime for the CURRENT ``self.node_id``:
        the Node (scheduler, worker pool, store, actors), the bulk data
        server over its store, and the p2p endpoint.  Called at start and
        again by the self-fence path, which rebuilds everything under a
        fresh node id."""
        from ray_tpu_torch.core.config import get_config
        from ray_tpu_torch.runtime import data_plane, p2p
        from ray_tpu_torch.runtime.node import Node

        cfg = get_config()
        self.node = Node(
            self.node_id, self.resources, self.fabric,
            shm_store=self.shm_store, labels=self.labels,
            # workers spawned on this node advertise dialable hosts for
            # their lazy p2p endpoints (worker_pool spawn env;
            # p2p.ensure_endpoint) — passed through the constructor so even
            # the prestarted worker gets them
            data_ip=conn.local_ip, head_ip=conn.peer_ip,
        )
        self.fabric.node = self.node
        # Bulk data plane: this node serves its local store to peers and
        # pulls dependencies directly from whichever peer holds them (the
        # head is only the address book — see data_plane.py docstring).
        # Bind all interfaces; advertise the IP this host is reachable at
        # from the head's side of the control connection (loopback would be
        # undialable for peers on other machines).
        self.data_server = data_plane.store_server(
            self.node.store, host="0.0.0.0", shm_store=self.shm_store
        )
        # leased direct dispatch: submitters holding a worker lease push
        # repeat-shape tasks straight here (push_task frames); results flow
        # back owner-to-owner on the same connection — the head control
        # channel carries lease churn, not per-task traffic
        self.data_server.task_handler = self._handle_pushed_task
        self.data_address = f"{conn.local_ip}:{self.data_server.port}"
        if self.fabric.data_client is None:
            self.fabric.data_client = data_plane.DataClient(
                chunk_bytes=cfg.object_transfer_chunk_bytes,
                max_concurrent=cfg.max_concurrent_object_transfers,
            )
        # collectives in this process send/recv store-to-store on the data
        # plane (runtime/p2p.py) instead of polling values through the KV
        p2p.register_endpoint(self.node.store, self.fabric.data_client, self.data_address)
        p2p.set_local_node(self.node_id.hex())
        self.node.worker_pool.log_sink = self._log_sink

    def _log_sink(self, line: str) -> None:
        flush = None
        with self._log_lock:
            self._log_buf.append(line)
            now = time.monotonic()
            if len(self._log_buf) >= 50 or now - self._log_last_flush > 0.2:
                flush, self._log_buf = self._log_buf, []
                self._log_last_flush = now
        if flush:
            try:
                self.conn.send("log_batch", {"lines": flush})
            except rpc.RpcError:
                pass

    def _register(
        self, rejoin: bool, conn: Optional[rpc.RpcConnection] = None,
        refenced: bool = False,
    ) -> dict:
        payload = {
            "node_id": self.node_id.binary(),
            "resources": self.resources,
            "labels": self.labels,
            "address": _self_address(),
            "data_address": self.data_address,
        }
        if refenced:
            # the previous incarnation of this agent was fenced; this is
            # the fresh-node rejoin after the self-fence (node_rejoins_total)
            payload["refenced"] = True
        if rejoin:
            payload["rejoin"] = True
            # reconciliation: the actor instances still alive in THIS
            # process, so the (possibly restarted) head can rebuild its
            # routing state for them
            payload["actors"] = [aid.binary() for aid in list(self.node.actors.keys())]
        return (conn or self.conn).request("register_node", payload)

    def _adopt_incarnation(self, reply: dict) -> None:
        self.incarnation = int(reply.get("incarnation") or 0)
        self.fabric.incarnation = self.incarnation
        # channel frames (chan_push) carry (node, incarnation) too so peer
        # data servers can fence a stale epoch's compiled-plan streams
        from ray_tpu_torch.runtime import data_plane

        data_plane.set_local_source(self.node_id.hex(), self.incarnation)

    # -- incarnation fencing (gray failures) ----------------------------
    def _h_fenced(self, conn, payload) -> None:
        """The head rejected one of our frames as a stale incarnation: this
        epoch's commits will never be accepted again.  Self-fence off the
        dispatch thread (teardown joins worker processes).  Notices naming
        an incarnation we already shed (straggler frames sent before a
        completed self-fence) are ignored — they must not re-fence the
        fresh, healthy epoch."""
        fenced_inc = payload.get("incarnation")
        if fenced_inc is not None and fenced_inc != self.incarnation:
            return
        self._start_refence(conn)

    def _h_peer_fenced(self, conn, payload) -> None:
        """A peer node's incarnation was fenced cluster-wide: reject its
        chan_push frames at this agent's data server too."""
        from ray_tpu_torch.runtime import data_plane

        node_hex = payload.get("node")
        if node_hex:
            data_plane.fence_source(node_hex)

    def _refence_single_flight(self, conn) -> bool:
        """Run the self-fence unless another thread already owns it (or the
        agent is stopping) — the ONE single-flight protocol both trigger
        paths (fenced notice, fenced rejoin reply) share.  Returns False
        when skipped; exceptions propagate to the caller."""
        with self._reconnect_lock:
            if self._refencing or self._stop.is_set():
                return False
            self._refencing = True
        try:
            self._refence(conn)
        finally:
            with self._reconnect_lock:
                self._refencing = False
        return True

    def _start_refence(self, conn) -> None:
        threading.Thread(
            target=self._refence_thread, args=(conn,), name="agent-refence", daemon=True
        ).start()

    def _refence_thread(self, conn) -> None:
        try:
            self._refence_single_flight(conn)
        except BaseException as exc:  # noqa: BLE001 — cannot recover: exit
            print(f"ray_tpu_torch agent: self-fence failed: {exc!r}", file=sys.stderr)
            self._stop.set()

    def _refence(self, conn: rpc.RpcConnection) -> None:
        """Self-fence and rejoin FRESH: kill this node's
        workers and actors, drop its store and lease pins (they die with
        the worker pool), release compiled-plan channels, then build a new
        Node under a NEW node id and register it through the normal
        elasticity path.  Everything the old incarnation still had in
        flight is garbage by definition — the head's death sweep already
        resubmitted/recovered around it."""
        print(
            "ray_tpu_torch agent: incarnation fenced — self-fencing and rejoining "
            "as a fresh node",
            file=sys.stderr,
        )
        try:
            from ray_tpu_torch.runtime import channel_manager

            channel_manager.uninstall_all_remote_plans()
        except Exception:  # noqa: BLE001 — plan channels die with the node
            pass
        old_node = self.node
        if old_node is not None:
            old_node.shutdown()  # kills actors + pool workers; pins clear
        if getattr(self, "data_server", None) is not None:
            self.data_server.close()  # old store must not serve stale bytes
        # drop the fenced epoch's fabric state (remembered specs, dedup
        # window, buffered location notices for the dropped store)
        self.fabric.reset_epoch()
        _reset_collectives()
        self.node_id = NodeID.from_random()
        self._build_node_runtime(conn)
        reply = self._register(rejoin=False, conn=conn, refenced=True)
        if reply.get("fenced"):
            from ray_tpu_torch.exceptions import FencedError

            raise FencedError(self.node_id, self.incarnation)
        self._adopt_incarnation(reply)
        print(
            f"ray_tpu_torch agent: rejoined as fresh node {self.node_id.hex()[:8]}",
            file=sys.stderr,
        )

    # -- head fault tolerance -------------------------------------------
    def _reconnect_loop(self) -> None:
        """The head went away: keep the node alive and retry with backoff
        (reference: raylets reconnect to a restarted GCS —
        ``core_worker.proto:443 RayletNotifyGCSRestart``).  Gives up and
        exits after ``agent_reconnect_timeout_s`` (0 disables rejoin)."""
        from ray_tpu_torch.core.config import get_config

        window = get_config().agent_reconnect_timeout_s
        if window <= 0:
            self._stop.set()
            return
        deadline = time.monotonic() + window
        backoff = 0.5
        while not self._stop.is_set() and time.monotonic() < deadline:
            try:
                # on success _rejoin clears _reconnecting ITSELF (before
                # arming the disconnect hook) so an immediate second outage
                # can spawn the next loop — a finally here would stomp that
                # new loop's flag
                self._rejoin()
                print(
                    f"ray_tpu_torch agent: rejoined head at {self.head_address}",
                    file=sys.stderr,
                )
                return
            except rpc.ProtocolMismatchError as exc:
                # PERMANENT: a restarted head with a different wire version
                # will never accept us — fail fast with the diagnostic
                # instead of hammering it for the whole window
                print(f"ray_tpu_torch agent: {exc}", file=sys.stderr)
                break
            except (OSError, rpc.RpcError):
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 5.0)
        self._stop.set()
        with self._reconnect_lock:
            self._reconnecting = False

    def _rejoin(self) -> None:
        conn = rpc.connect(
            self.head_address,
            handlers=self._handlers(),
            # no disconnect hook while joining: a failed attempt must not
            # spawn a second reconnect loop; installed only on success below
            on_disconnect=None,
            name="agent",
        )
        try:
            reply = conn.request("register_node_config", {})
            self._check_protocol(reply)
            self._adopt_config(reply)
            # the data server survived; the reachable IP may differ on a new
            # connection (multi-NIC), recompute the advertisement
            self.data_address = f"{conn.local_ip}:{self.data_server.port}"
            from ray_tpu_torch.runtime import p2p
            from ray_tpu_torch.runtime.kv_client import register_agent_kv

            reg = self._register(rejoin=True, conn=conn)
            if not reg.get("fenced"):
                # adopt the NEW incarnation BEFORE publishing the connection
                # to the fabric: a completion sent in between would carry
                # the stale stamp and be fenced — stranding its spec and
                # spuriously re-fencing a healthy, just-rejoined node
                self._adopt_incarnation(reg)
            # registration done: publish the new epoch to the rest of the
            # process, then arm the disconnect hook
            self.conn = conn
            self.fabric.conn = conn
            register_agent_kv(conn)
            if reg.get("fenced"):
                # the head declared this node dead during the partition: the
                # old incarnation can never rejoin.  Self-fence (kill
                # workers, drop the store + pins) and join as a FRESH node
                # on this connection — the partition-heal rejoin path.
                # Single-flight against a notice-triggered refence racing in
                # on the new connection's dispatch thread.
                self._refence_single_flight(conn)
            else:
                p2p.register_endpoint(self.node.store, self.fabric.data_client, self.data_address)
                # collective groups/counters index the PREVIOUS head
                # incarnation: a rank here holding generation N would desync
                # against restarted driver-side ranks born at generation 0
                _reset_collectives()
        except BaseException:
            conn.close()
            raise
        # clear the single-flight flag BEFORE arming the hook: a disconnect
        # that lands immediately after arming must be able to start the next
        # reconnect loop (otherwise it sees _reconnecting=True, returns, and
        # the agent zombies — alive, headless, never retrying)
        with self._reconnect_lock:
            self._reconnecting = False
        conn._on_disconnect = self._on_disconnect
        if conn.closed:
            # teardown ran before the hook was armed: fire it ourselves
            self._on_disconnect(conn)
            return
        self._report_thread = threading.Thread(
            target=self._report_loop, args=(conn,), name="agent-report", daemon=True
        )
        self._report_thread.start()

    def _check_protocol(self, reply: dict) -> None:
        """Same-version-everywhere is the pickle-frame contract — verify it
        EXPLICITLY instead of corrupting silently (reference: versioned
        protobuf schemas play this role)."""
        head_version = reply.get("protocol_version")
        head_name = reply.get("protocol")
        if head_name != rpc.PROTOCOL_NAME:
            # a JAX-package head (it names no protocol family): its frames
            # carry that package's values, which this agent cannot serve
            raise rpc.ProtocolMismatchError(
                f"protocol mismatch: head speaks {head_name or 'ray_tpu'} "
                f"v{head_version}, this agent speaks {rpc.PROTOCOL_NAME} "
                f"v{rpc.PROTOCOL_VERSION} — a node agent joins a head of its "
                "own package only"
            )
        if head_version != rpc.PROTOCOL_VERSION:
            raise rpc.ProtocolMismatchError(
                f"protocol version mismatch: head speaks v{head_version}, "
                f"this agent speaks v{rpc.PROTOCOL_VERSION} — upgrade the "
                "older side; mixed-version clusters are not supported"
            )

    def _adopt_config(self, reply: dict) -> None:
        """Adopt the (possibly restarted) head's config so thresholds and
        timeouts agree cluster-wide (node.py:1377-1392 parity)."""
        from ray_tpu_torch.core.config import Config, set_config

        cfg = Config()
        cfg.apply_dict({k: v for k, v in reply.get("config", {}).items() if hasattr(cfg, k)})
        set_config(cfg)
        key = reply.get("ipc_authkey")
        if key:
            # the head's CUDA IPC key (a head on this host sends it): the
            # device rung of a pull between the two then authenticates.  A
            # rejoin to a restarted head may bring a new key; a transfer
            # server built under the old one is rebuilt under this one
            import multiprocessing

            from ray_tpu_torch.runtime import device_plane

            multiprocessing.current_process().authkey = bytes(key)
            device_plane.rekey_transfer_server()
        if cfg.failpoints:
            # the head's chaos spec covers the whole fabric: arm the same
            # failpoints (and decision seed) in this agent process
            from ray_tpu_torch.runtime import failpoints

            failpoints.arm(cfg.failpoints, seed=cfg.failpoint_seed)

    def _flush_logs(self) -> None:
        with self._log_lock:
            flush, self._log_buf = self._log_buf, []
            self._log_last_flush = time.monotonic()
        if flush:
            try:
                self.conn.send("log_batch", {"lines": flush})
            except rpc.RpcError:
                pass

    def wait(self) -> None:
        self._stop.wait()

    # ------------------------------------------------------------------
    def _handlers(self) -> dict:
        return {
            "submit_task": self._h_submit_task,
            "submit_actor_task": self._h_submit_actor_task,
            "submit_actor_task_batch": self._h_submit_actor_task_batch,
            "create_actor": self._h_create_actor,
            "kill_actor": self._h_kill_actor,
            "cancel_task": self._h_cancel_task,
            "pool_update": self._h_pool_update,
            "push_object": self._h_push_object,
            "fetch_object": self._h_fetch_object,
            "delete_object": self._h_delete_object,
            "shutdown": self._h_shutdown,
            "coll_fail": self._h_coll_fail,
            "dump_stacks": self._h_dump_stacks,
            "install_plan": self._h_install_plan,
            "uninstall_plan": self._h_uninstall_plan,
            "fenced": self._h_fenced,
            "peer_fenced": self._h_peer_fenced,
            "ping": lambda c, p, rid=None: {},
        }

    def _h_install_plan(self, conn, payload, rid=None) -> dict:
        """Install a compiled execution plan's stage program ONCE: register
        this process's channels, open the persistent outbound streams, and
        start the stage loops.  Every subsequent plan.execute is pure
        data-plane traffic — this control connection never sees it."""
        from ray_tpu_torch.runtime import channel_manager

        channel_manager.install_remote_plan(payload, self.node, conn)
        return {}

    def _h_uninstall_plan(self, conn, payload, rid=None) -> dict:
        from ray_tpu_torch.runtime import channel_manager

        channel_manager.uninstall_remote_plan(payload["plan"])
        return {}

    def _h_dump_stacks(self, conn, payload: dict, rid: int):
        """`rt stack`: this agent's threads + its pool workers'.  Collected
        OFF the dispatch thread — worker replies need the connection live."""
        import threading as _t

        from ray_tpu_torch.runtime import stack as _stack

        def run():
            try:
                out = _stack.node_stacks(self.node, timeout=float(payload.get("timeout", 5.0)))
                conn.send_reply(rid, out)
            except Exception:  # noqa: BLE001
                import traceback as _tb

                conn.send_reply(rid, {"_exc": _tb.format_exc()})

        _t.Thread(target=run, name="stack-dump", daemon=True).start()
        return rpc.DEFER

    def _h_coll_fail(self, conn, payload) -> None:
        """Cluster-wide collective death notice: fail open waits in THIS
        process and relay to this node's pool workers."""
        from ray_tpu_torch.runtime import p2p

        groups, reason = payload["groups"], payload["reason"]
        for g in groups:
            p2p.fail_group(g, reason)
        if self.node is not None:
            self.node.worker_pool.broadcast_fail_group(groups, reason)

    def _decode(self, payload: dict):
        spec = rpc.decode_spec(payload["spec"], self._fn_cache)
        self.fabric._remember(spec)
        return spec

    def _h_submit_task(self, conn, payload) -> None:
        enc = payload["spec"]
        if self.fabric.pushed_duplicate(enc["task_id"], enc["attempt"]):
            # the owner's control fallback raced a push that WAS delivered
            # here: that copy ran (or is running) and its completion reaches
            # the owner on its own — running this duplicate would break
            # exactly-once side effects
            return
        self.node.submit(self._decode(payload))

    # -- leased direct dispatch (data-plane push_task) -------------------
    def _handle_pushed_task(self, spec_blob: bytes, accept):
        """Run one peer-pushed TaskSpec and return its owner-routed result
        frames: ``(header, meta, buffers, reply_failed)`` — meta None means
        the header alone carries the outcome (error / lazy commit), and
        ``reply_failed`` (None until the task is accepted) re-routes the
        completion over the control channel when the data-plane reply can't
        reach the owner.  ``accept()`` sends the delivery ack and must
        succeed BEFORE dispatch: once the owner reads it, it never falls
        back to a control resubmit.  Runs on the data connection's
        dedicated serve thread; blocking until the task commits IS the
        owner's wait."""
        import pickle as _pickle

        payload = _pickle.loads(spec_blob)
        try:
            spec = rpc.decode_spec(payload, self._fn_cache)
        except rpc.FunctionNotCached:
            # the function blob rode an earlier control-plane submit whose
            # frame hasn't landed (cross-channel race): ask the owner to
            # resend with the blob inline
            return {"ok": False, "need_fn": True}, None, None, None
        box: Dict[str, Any] = {}
        done = threading.Event()
        spec._push_reply = (box, done)
        spec._leased = True  # pin a warm process worker to the shape
        # accept BEFORE _remember: a remembered-but-never-accepted spec
        # would make pushed_duplicate drop the owner's control fallback for
        # a task that never ran — losing it forever
        accept()  # ConnectionError/OSError -> the owner's fallback owns it
        self.fabric._remember(spec)

        def reply_failed() -> None:
            # the owner never confirmed the data-plane reply — and it never
            # resubmits a delivered push — so the completion must travel the
            # control channel (on_task_finished_msg resolves the still-
            # tracked spec; a duplicate arrival no-ops on the untrack guard)
            try:
                self.fabric._send_task_finished(
                    spec, box.get("values") or [], box.get("result"), box.get("error")
                )
            except rpc.RpcError:
                pass  # head gone too: the node-death sweep owns the spec

        try:
            self.node.submit(spec)
        except Exception as exc:  # noqa: BLE001 — post-accept dispatch
            # failure: the owner will never resubmit, so this must surface
            # as a task outcome, not a dropped frame
            self.fabric._forget(spec)
            box["error"] = RuntimeError(f"pushed task dispatch failed: {exc!r}")
            done.set()
        # long wait by design (a pushed task may legitimately block on
        # nested work); a dead owner connection surfaces through the reply
        # send/receipt-ack, which re-routes via reply_failed
        if not done.wait(24 * 3600.0):
            # wedged worker: an ok-reply with an empty box would commit
            # None as the result — surface a typed failure instead
            err = RuntimeError("pushed task did not commit within 24h")
            box.setdefault("error", err)
            return {
                "ok": True, "error": rpc.encode_value(err),
                "spans": self.fabric._drained_spans(),
                "src": (self.node_id.hex(), self.incarnation),
            }, None, None, reply_failed
        error = box.get("error")
        spans = self.fabric._drained_spans()
        # (node, incarnation) stamp: the owner fences results from a
        # superseded epoch (the death sweep already resubmitted the task)
        src = (self.node_id.hex(), self.incarnation)
        if error is not None:
            return (
                {"ok": True, "error": rpc.encode_value(error), "spans": spans,
                 "src": src},
                None, None, reply_failed,
            )
        result = box.get("result")
        from ray_tpu_torch.core.config import get_config

        threshold = get_config().data_plane_inline_bytes
        from ray_tpu_torch.runtime.remote_node import _bulk_size

        values = box.get("values", ())

        def lazy_header():
            from ray_tpu_torch.core.object_store import _is_device_array as is_device_array
            from ray_tpu_torch.runtime.remote_node import _probe_nbytes

            return {
                "ok": True, "lazy": True, "spans": spans, "src": src,
                "device_returns": [is_device_array(v) for v in values],
                "return_sizes": [_probe_nbytes(v)[0] for v in values],
            }, None, None, reply_failed

        if _bulk_size(result) > threshold:
            # bulk result: bytes stay in this node's store (the lazy-commit
            # contract) — the owner records the location, consumers pull
            # peer-to-peer on demand
            return lazy_header()
        from ray_tpu_torch.runtime import data_plane

        meta, buffers = data_plane.to_frames(result)
        total = len(meta) + sum(memoryview(b).cast("B").nbytes for b in buffers)
        if total > threshold:
            return lazy_header()
        return {"ok": True, "spans": spans, "src": src}, meta, buffers, reply_failed

    def _h_submit_actor_task(self, conn, payload) -> None:
        self.node.submit_actor_task(self._decode(payload))

    def _h_submit_actor_task_batch(self, conn, payload) -> None:
        specs = [self._decode({"spec": enc}) for enc in payload["specs"]]
        # same-actor batches cascade into one worker IPC frame downstream
        self.node.submit_actor_task_batch(specs)

    def _h_create_actor(self, conn, payload) -> None:
        spec = self._decode(payload)
        self.node.create_actor(spec, payload["mode"], payload["max_concurrency"])

    def _h_kill_actor(self, conn, payload) -> None:
        self.node.kill_actor(ActorID(payload["actor_id"]))

    def _h_cancel_task(self, conn, payload) -> None:
        spec = self.fabric.lookup_spec(payload["task_id"])
        if spec is not None:
            spec._cancelled = True
            self.node.cancel_task(spec, force=payload.get("force", False))

    def _h_pool_update(self, conn, payload) -> None:
        rset = ResourceSet.from_fixed_dict(payload["resources"])
        op = payload["op"]
        pool = self.node.pool
        if op == "acquire":
            pool.force_acquire(rset)
        elif op == "release":
            pool.release(rset)
        elif op == "add_capacity":
            pool.add_capacity(rset)
        elif op == "remove_capacity":
            pool.remove_capacity(rset)

    def _h_push_object(self, conn, payload) -> None:
        value, is_error = rpc.decode_value(payload)
        self.node.store.put(ObjectID(payload["oid"]), value, is_error=is_error)

    def _h_fetch_object(self, conn, payload, rid):
        # Resolve asynchronously: a blocking store.get here would park the
        # connection's single dispatch thread, so the very push_object frame
        # that could satisfy it (or any submit/cancel behind it) would queue
        # forever — the head-side RemoteStore.get would only unblock at its
        # own timeout.  DEFER keeps the dispatch thread free.
        oid = ObjectID(payload["oid"])
        fut = self.node.store.get_async(oid)
        replied = threading.Event()

        def reply_once(payload_dict: dict) -> None:
            if not replied.is_set():
                replied.set()
                conn.send_reply(rid, payload_dict)

        def on_done(f):
            try:
                value = f.result()
            except Exception as exc:  # noqa: BLE001 — relay, don't kill dispatch
                reply_once({"_exc": repr(exc)})
                return
            info = self.node.store.entry_info(oid)
            reply_once(rpc.encode_value(value, bool(info and info["is_error"])))

        # bound the deferral: without it an object that never materializes
        # keeps the rid + connection captured forever (the head-side request
        # already timed out and popped the rid anyway)
        timer = threading.Timer(30.0, reply_once, args=({"_exc": "fetch_object timed out"},))
        timer.daemon = True
        timer.start()
        fut.add_done_callback(on_done)
        fut.add_done_callback(lambda f: timer.cancel())
        return rpc.DEFER

    def _h_delete_object(self, conn, payload) -> None:
        self.node.store.delete(ObjectID(payload["oid"]))

    def _h_shutdown(self, conn, payload) -> None:
        self._stop.set()

    # ------------------------------------------------------------------
    def _report_loop(self, conn: rpc.RpcConnection) -> None:
        """One report loop per connection epoch; exits when ITS connection
        dies (the rejoin path starts a fresh one)."""
        from ray_tpu_torch.core.config import get_config
        from ray_tpu_torch.dashboard.reporter import SystemSampler

        sampler = SystemSampler()
        period = max(0.02, get_config().resource_sync_period_s)
        last_sample = 0.0
        chaos_sent = 0  # fault-log shipping cursor (append-only log)
        from ray_tpu_torch.runtime import failpoints

        while not self._stop.is_set() and not conn.closed:
            if failpoints.ARMED:
                # chaos: a dropped/partitioned heartbeat skips this tick's
                # report entirely — enough consecutive drops and the head's
                # health checker declares this node dead (the exact flaky-
                # agent failure mode the recovery path must survive)
                try:
                    action = failpoints.fp("agent.heartbeat")
                except failpoints.FailpointInjected:
                    action = "drop"
                if action is not None:
                    self._stop.wait(period)
                    continue
            try:
                pool = self.node.pool
                report = {
                    "total": pool.total.fixed(),
                    "available": pool.available.fixed(),
                    "queue_len": self.node.scheduler.queue_len(),
                    "stats": self.node.scheduler.stats(),
                    # incarnation stamp: a superseded epoch's heartbeat must
                    # not refresh the liveness of the CURRENT one
                    "inc": self.incarnation,
                }
                # reporter piggyback: CPU/mem/TPU utilization, sampled at
                # the HISTORY's cadence (2s), not the hot report tick — the
                # head ring-buffers at 2s anyway, so faster sampling is
                # /proc+jax I/O thrown away
                now = time.monotonic()
                if now - last_sample >= 2.0:
                    last_sample = now
                    report["metrics"] = sampler.sample()
                    # data/device-plane counters ride the same piggyback so
                    # the dashboard can show live per-node transfer stats
                    try:
                        from ray_tpu_torch.runtime import device_plane

                        report["transfers"] = {
                            "data_server": self.data_server.stats.snapshot(),
                            "data_client": self.fabric.data_client.stats.snapshot(),
                            "device": device_plane.stats.snapshot(),
                        }
                    except Exception:  # noqa: BLE001 — stats must not kill reports
                        pass
                    # armed chaos: ship this agent's fault-log TAIL so the
                    # head can audit a multihost chaos run. Cursor-based —
                    # the log only appends, and re-serializing the whole
                    # run every tick would grow heartbeat frames O(n)
                    if failpoints.ARMED:
                        try:
                            tail = failpoints.raw_log(chaos_sent)
                            if tail:
                                report["chaos_faults"] = tail
                                chaos_sent += len(tail)
                        except Exception:  # noqa: BLE001
                            pass
                    # shm-arena occupancy: the arena lives in THIS process,
                    # so the head's /api/memory can only see it by piggyback
                    if self.shm_store is not None:
                        try:
                            report["arena"] = {
                                "used": self.shm_store.used_bytes,
                                "capacity": self.shm_store.capacity,
                                "objects": self.shm_store.num_objects,
                            }
                        except OSError:
                            pass
                conn.send("resource_report", report)
            except rpc.RpcError:
                return
            try:
                # lease-pin hygiene rides the report cadence: expire pins
                # whose shape went quiet (head expiry can't reach this pool)
                self.node.worker_pool.sweep_stale_pins()
            except Exception:  # noqa: BLE001 — hygiene must not kill reports
                pass
            self._flush_logs()
            self._stop.wait(period)

    def _on_disconnect(self, conn) -> None:
        # The head went away. Unlike round 2 (exit immediately), keep this
        # node and its state alive and try to rejoin a restarted head; only
        # exit once the reconnect window expires.
        if self._stop.is_set() or conn is not self.conn:
            return  # deliberate shutdown, or an old epoch's connection
        with self._reconnect_lock:
            if self._reconnecting:
                return  # one reconnect loop at a time
            self._reconnecting = True
        threading.Thread(
            target=self._reconnect_loop, name="agent-reconnect", daemon=True
        ).start()

    def shutdown(self) -> None:
        self._stop.set()
        # The report loop reads the shm arena header through ctypes; closing
        # the store (munmap) under it is a use-after-free no except-clause
        # can catch.  Join it (bounded — it wakes from its wait on _stop)
        # before the arena goes away.
        t = getattr(self, "_report_thread", None)
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        try:
            from ray_tpu_torch.runtime import channel_manager

            channel_manager.uninstall_all_remote_plans()
        except Exception:  # noqa: BLE001 — plan channels die with the process
            pass
        if self.node is not None:
            self.node.shutdown()
        from ray_tpu_torch.runtime import p2p

        p2p.clear_endpoint()
        _reset_collectives()
        if getattr(self, "shm_store", None) is not None:
            try:
                self.shm_store.close()
                self.shm_store.unlink()
            except Exception:  # noqa: BLE001
                pass
        if getattr(self, "data_server", None) is not None:
            self.data_server.close()
        if self.fabric.data_client is not None:
            self.fabric.data_client.close()
        if self.conn is not None:
            self.conn.close()


def _ref_free(v, depth: int = 0) -> bool:
    """WHITELIST: only value shapes that provably hold no ObjectRef qualify
    for agent-local fast paths (an arbitrary object could hide a ref
    needing the driver's borrower/pinning bookkeeping — those fall back)."""
    import numpy as _np

    from ray_tpu_torch.core.object_ref import ObjectRef

    if v is None or isinstance(v, (bool, int, float, str, bytes, bytearray, _np.generic)):
        return True
    if isinstance(v, _np.ndarray):
        return v.dtype != object  # object arrays can hide ObjectRefs
    from ray_tpu_torch.runtime.device_plane import is_device_array

    if is_device_array(v):
        return True
    if depth >= 3 or isinstance(v, ObjectRef):
        return False
    if isinstance(v, dict):
        return all(_ref_free(x, depth + 1) for kv in v.items() for x in kv)
    if isinstance(v, (list, tuple)):
        return all(_ref_free(x, depth + 1) for x in v)
    return False


def _reset_collectives() -> None:
    """Drop this process's collective groups (loaded only where a group was
    used: the module imports torch)."""
    collective = sys.modules.get("ray_tpu_torch.parallel.collective")
    if collective is not None:
        collective.reset_module_state()


#: ``/dev/shm`` name of an agent's arena: the port's segment prefix, then
#: ``a<pid in hex>_<random hex>`` (the JAX package's agents use ``rt_a``)
AGENT_SEGMENT_RE = r"rttorch_a([0-9a-f]+)_[0-9a-f]+$"


def agent_segment_name() -> str:
    from ray_tpu_torch.native.shm_store import SEGMENT_PREFIX

    return f"{SEGMENT_PREFIX}a{os.getpid():x}_{os.urandom(3).hex()}"


def _gc_stale_shm_segments() -> None:
    """Unlink this package's /dev/shm/rttorch_a<pid>_* agent segments whose
    owning process is gone (SIGKILL leaves them behind; they are RAM until
    someone reaps them).  Another package's segments never match."""
    import re

    try:
        names = os.listdir("/dev/shm")
    except OSError:
        return
    for name in names:
        m = re.match(AGENT_SEGMENT_RE, name)
        if not m:
            continue
        try:
            pid = int(m.group(1), 16)
            os.kill(pid, 0)  # raises if the owner is dead
        except ProcessLookupError:
            try:
                os.unlink(os.path.join("/dev/shm", name))
            except OSError:
                pass
        except (OSError, ValueError):
            pass  # alive or unparsable: leave it


def _self_address() -> str:
    import socket

    try:
        return socket.gethostname()
    except OSError:
        return "?"


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description="ray_tpu_torch node agent")
    parser.add_argument("--address", required=True, help="head host:port")
    parser.add_argument("--num-cpus", type=float, default=None)
    parser.add_argument("--num-gpus", type=float, default=None,
                        help="CUDA devices this node offers (the GPU resource)")
    parser.add_argument("--num-tpus", type=float, default=None)
    parser.add_argument("--resources", default="{}", help="JSON extra resources")
    parser.add_argument("--labels", default="{}", help="JSON node labels")
    args = parser.parse_args(argv)

    resources = dict(json.loads(args.resources))
    resources["CPU"] = args.num_cpus if args.num_cpus is not None else (os.cpu_count() or 4)
    if args.num_tpus is not None:
        resources["TPU"] = args.num_tpus
    if args.num_gpus:
        # never register a card this process cannot reach
        from ray_tpu_torch.accelerators.gpu import get_num_gpus

        seen = get_num_gpus()
        if seen < args.num_gpus:
            print(
                f"ray_tpu_torch agent: --num-gpus {args.num_gpus:g} asks for more "
                f"CUDA devices than this process sees ({seen})",
                file=sys.stderr,
            )
            return 2
        resources["GPU"] = args.num_gpus
    else:
        # a node offering no GPU keeps its process and its workers off the
        # card: nothing here (the store's budget, the reporter) may create
        # a CUDA context
        os.environ["CUDA_VISIBLE_DEVICES"] = ""

    labels = dict(json.loads(args.labels))
    # Cloud TPU sets TPU_WORKER_ID per slice host: record it so gang
    # placement and the dashboard see each host's index in its slice
    # (reference: accelerators/tpu.py worker-id detection).
    if "TPU_WORKER_ID" in os.environ and "ray_tpu.io/worker-index" not in labels:
        labels["ray_tpu.io/worker-index"] = os.environ["TPU_WORKER_ID"]

    # chaos: a RAY_TPU_FAILPOINTS spec on the agent's environment arms this
    # process even before registration (the head's config-borne spec, if
    # any, merges in at _adopt_config)
    from ray_tpu_torch.runtime import failpoints

    failpoints.arm_from_env()

    agent = NodeAgent(args.address, resources, labels=labels)
    # graceful SIGTERM: unlink the shm arena and leave the cluster cleanly
    import signal as _signal

    _signal.signal(_signal.SIGTERM, lambda *_a: agent.shutdown())
    try:
        agent.start()
    except (OSError, rpc.RpcError) as exc:
        print(f"ray_tpu_torch agent: cannot join {args.address}: {exc}", file=sys.stderr)
        return 1
    print(f"ray_tpu_torch agent joined {args.address} as node {agent.node_id.hex()[:8]}", file=sys.stderr)
    try:
        agent.wait()
    except KeyboardInterrupt:
        pass
    agent.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
