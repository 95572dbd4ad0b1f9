"""The port's disaggregated prefill/decode against the JAX package's.

A prefill engine exports a prompt's KV blocks, a decode engine pulls them and
continues: the migrated greedy tokens equal the JAX package's ``generate`` and
its own disaggregated path, on the same converted weights (small f32 config,
as tests/test_disagg.py). Also the header-only ticket, the block uuids, role
validation, the warm-prefix short circuit, the typed error of a released
staging, the device rung through the fake transfer server, and that neither
engine leaks a page. The port runs on the CPU.
"""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from ray_tpu.models import generate as jax_generate  # noqa: E402
from ray_tpu.models import init_params as jax_init_params  # noqa: E402
from ray_tpu.serve import disagg as jdisagg  # noqa: E402
from ray_tpu.serve.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu_torch.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from ray_tpu_torch.runtime import data_plane, device_plane  # noqa: E402
from ray_tpu_torch.runtime.fake_transfer import FakeTransferServer  # noqa: E402
from ray_tpu_torch.serve import disagg  # noqa: E402
from ray_tpu_torch.serve.llm import LLMEngine, LLMServer  # noqa: E402

SMALL = dict(vocab_size=89, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64)
JCFG = JaxConfig(**SMALL, attention="dense", dtype=jnp.float32)
CFG = TransformerConfig(**SMALL, attention="dense", dtype=torch.float32)
PROMPT = [3, 14, 15, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4, 6]  # 19 -> 2 blocks


@pytest.fixture(scope="module")
def params():
    jp = jax_init_params(JCFG, jax.random.key(11))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _reference(jp, prompt, n):
    out, lens = jax_generate(JCFG, jp, jnp.asarray([prompt], jnp.int32), max_new_tokens=n,
                             temperature=0)
    return np.asarray(out[0, len(prompt): int(lens[0])]).tolist()


def _paged(tp, **kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_seq_len", 64)
    return LLMEngine(CFG, tp, device="cpu", cache_kind="paged", **kw)


def _wait(pred, timeout=60):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.005)
    assert pred()


def _assert_no_leak(eng):
    """Quiesced-engine leak check: every held page is the prefix cache's,
    and flushing it empties the pool."""
    _wait(lambda: eng.stats()["active_slots"] == 0 and eng.stats()["prefilling"] == 0)
    st = eng.stats()
    assert st["kv_blocks_in_use"] == st["prefix_cache_blocks"]
    eng.flush_prefix_cache()
    st = eng.stats()
    assert st["kv_blocks_in_use"] == 0 and st["prefix_cache_blocks"] == 0


def _migrate(mod, p_eng, d_eng, prompt, mig_id, max_tokens=6):
    """Export on ``p_eng``, pull only the blocks ``d_eng``'s prefix cache
    lacks, adopt on ``d_eng`` (``mod`` is either package's disagg module).
    Returns ``(ticket, tokens, rungs)``, one rung per block pulled."""
    ticket = p_eng.prefill_export(prompt, mig_id=mig_id).result(timeout=120)
    bs = d_eng.kv_block_size
    matched = d_eng.peek_prefix_match(prompt)
    arrays, rungs = {}, []
    for bidx in range(matched // bs, int(ticket["n_blocks"])):
        arr, rung = mod.pull_block(ticket, bidx)
        arrays[bidx] = arr
        rungs.append(rung)
    out = d_eng.adopt_migration(ticket, arrays, max_tokens=max_tokens).future.result(timeout=120)
    return ticket, out, rungs


# --------------------------------------------------------------------------
# identity and wire format
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mig_id", ["LLMServer/m1", "LLMServer/m2", "d/m7#a1", "", "ünï/çødé"])
def test_migration_uuid_equals_jax(mig_id):
    for bidx in (0, 1, 5, 63, 2**31, 2**32 - 1, 2**32 + 3):
        assert disagg.migration_uuid(mig_id, bidx) == jdisagg.migration_uuid(mig_id, bidx)
    assert disagg.migration_uuid(mig_id, 5) & 0xFFFFFFFF == 5
    assert disagg.migration_uuid(mig_id, 0) != 0


@pytest.mark.parametrize("roles,kw", [
    (None, None),
    ({"prefill": 2, "decode": 3}, None),
    ({"prefill": 1, "decode": 1, "draft": 1}, None),
    ({"prefill": 2}, None),
    ({"prefill": 0, "decode": 2}, None),
    ({"prefill": 1, "decode": 1}, {"cache_kind": "dense"}),
    ({"prefill": 1, "decode": 1}, {"cache_kind": "paged"}),
])
def test_validate_roles_raises_the_same_errors(roles, kw):
    def outcome(mod):
        try:
            mod.validate_roles(roles, kw)
        except ValueError as exc:
            return str(exc)
        return None

    assert outcome(disagg) == outcome(jdisagg)


def test_engine_roles_validate_as_jax(params):
    jp, tp = params
    for kw in ({"role": "draft"}, {"role": "decode", "cache_kind": "dense"}):
        with pytest.raises(ValueError) as te:
            LLMEngine(CFG, tp, device="cpu", max_batch_size=2, max_seq_len=32, **kw)
        with pytest.raises(ValueError) as je:
            JaxEngine(JCFG, jp, max_batch_size=2, max_seq_len=32, **kw)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("prompt", [PROMPT, list(range(1, 33)), [5, 6, 7]],
                         ids=["2_blocks", "2_full_blocks", "1_block"])
def test_ticket_equals_jax(params, prompt):
    jp, tp = params
    j_eng, p_eng = JaxEngine(JCFG, jp, max_batch_size=4, max_seq_len=64), _paged(tp)
    try:
        jt = j_eng.prefill_export(prompt, mig_id="t/hdr").result(timeout=120)
        tt = p_eng.prefill_export(prompt, mig_id="t/hdr").result(timeout=120)
        assert set(tt) == set(jt)
        aside = {"transfer_addr", "data_addr", "source"}
        assert {k: v for k, v in tt.items() if k not in aside} == \
            {k: v for k, v in jt.items() if k not in aside}
        assert tt["block_dtype"] == "float32" and isinstance(tt["block_shape"], tuple)
        for v in tt.values():
            assert isinstance(v, (str, int, float, list, tuple, type(None)))
        assert len(json.dumps(tt)) < 2048
        assert p_eng.release_migration("t/hdr") and j_eng.release_migration("t/hdr")
        _assert_no_leak(p_eng)
    finally:
        j_eng.shutdown()
        p_eng.shutdown()


def test_bf16_ticket_names_the_dtype_as_jax(params):
    jp, tp = params
    j_eng = JaxEngine(JaxConfig(**SMALL, attention="dense", dtype=jnp.bfloat16), jp,
                      max_batch_size=2, max_seq_len=64)
    p_eng = LLMEngine(TransformerConfig(**SMALL, attention="dense", dtype=torch.bfloat16), tp,
                      device="cpu", max_batch_size=2, max_seq_len=64)
    try:
        jt = j_eng.prefill_export(PROMPT, mig_id="t/bf16").result(timeout=120)
        tt = p_eng.prefill_export(PROMPT, mig_id="t/bf16").result(timeout=120)
        assert (tt["block_dtype"], tt["block_shape"]) == (jt["block_dtype"], jt["block_shape"])
        assert tt["block_dtype"] == "bfloat16"
        arr, _ = disagg.pull_block(tt, 0)
        assert arr.dtype == torch.bfloat16 and tuple(arr.shape) == tt["block_shape"]
    finally:
        j_eng.shutdown()
        p_eng.shutdown()


# --------------------------------------------------------------------------
# migrated tokens
# --------------------------------------------------------------------------
@pytest.mark.parametrize("prompt,n", [(PROMPT, 8), (list(range(40, 8, -1)), 6), ([7, 7, 1], 5)],
                         ids=["2_blocks", "2_full_blocks", "1_block"])
def test_migrated_tokens_equal_jax_generate_and_jax_disagg(params, prompt, n):
    jp, tp = params
    jp_eng, jd_eng = (JaxEngine(JCFG, jp, max_batch_size=4, max_seq_len=64) for _ in range(2))
    p_eng, d_eng = _paged(tp, role="prefill"), _paged(tp, role="decode")
    try:
        ref = _reference(jp, prompt, n)
        _, jax_out, jax_rungs = _migrate(jdisagg, jp_eng, jd_eng, prompt, "t/ident", n)
        _, out, rungs = _migrate(disagg, p_eng, d_eng, prompt, "t/ident", n)
        assert out == jax_out == ref
        assert rungs == jax_rungs and set(rungs) == {"host"}
        st = p_eng.stats()
        assert (st["role"], st["migrations_out"], st["staged_migrations"]) == ("prefill", 1, 1)
        assert d_eng.stats()["migrations_in"] == 1 and d_eng.stats()["role"] == "decode"
        assert p_eng.release_migration("t/ident") is True
        assert p_eng.release_migration("t/ident") is False
        assert data_plane.kv_block_source("t/ident") is None
        _assert_no_leak(p_eng)
        _assert_no_leak(d_eng)
    finally:
        for e in (jp_eng, jd_eng, p_eng, d_eng):
            e.shutdown()


def test_warm_decode_prefix_short_circuits_re_migration(params):
    jp, tp = params
    p_eng, d_eng = _paged(tp), _paged(tp)
    try:
        prompt = [(7 * i + 3) % CFG.vocab_size for i in range(32)]  # 2 full blocks
        ref = _reference(jp, prompt, 6)
        _, out1, rungs1 = _migrate(disagg, p_eng, d_eng, prompt, "t/warm1")
        assert out1 == ref and len(rungs1) == 2  # cold decode side: every block
        assert p_eng.release_migration("t/warm1")
        _wait(lambda: d_eng.stats()["active_slots"] == 0)
        assert d_eng.peek_prefix_match(prompt) == 32  # landed in the decode prefix cache
        _, out2, rungs2 = _migrate(disagg, p_eng, d_eng, prompt, "t/warm2")
        assert out2 == ref and rungs2 == []  # full hit: zero blocks pulled
        assert p_eng.release_migration("t/warm2")
        prompt3 = prompt + [11, 12, 13, 14, 15, 16, 17, 18]  # 40 -> 3 blocks
        _, out3, rungs3 = _migrate(disagg, p_eng, d_eng, prompt3, "t/warm3", max_tokens=5)
        assert out3 == _reference(jp, prompt3, 5) and len(rungs3) == 1  # the suffix only
        assert p_eng.release_migration("t/warm3")
        _assert_no_leak(p_eng)
        _assert_no_leak(d_eng)
    finally:
        p_eng.shutdown()
        d_eng.shutdown()


def test_released_staging_raises_typed_error(params):
    _, tp = params
    p_eng = _paged(tp)
    try:
        ticket = p_eng.prefill_export(list(range(2, 21)), mig_id="t/gone").result(timeout=120)
        assert p_eng.release_migration("t/gone")
        with pytest.raises(disagg.KVMigrationError) as exc:
            disagg.pull_block(ticket, 0)
        assert exc.value.mig_id == "t/gone" and exc.value.stage == "staging"
        _assert_no_leak(p_eng)
    finally:
        p_eng.shutdown()


def test_block_missing_at_adoption_is_typed_migration_error(params):
    """A block neither pulled nor in the decode prefix cache fails the
    request with ``KVMigrationError``, and the decode engine leaks nothing."""
    _, tp = params
    p_eng, d_eng = _paged(tp), _paged(tp)
    try:
        ticket = p_eng.prefill_export(PROMPT, mig_id="t/short").result(timeout=120)
        arr, _ = disagg.pull_block(ticket, 0)
        req = d_eng.adopt_migration(ticket, {0: arr}, max_tokens=4)  # block 1 missing
        with pytest.raises(RuntimeError, match="KVMigrationError"):
            req.future.result(timeout=120)
        assert p_eng.release_migration("t/short")
        _assert_no_leak(d_eng)
    finally:
        p_eng.shutdown()
        d_eng.shutdown()


@pytest.fixture()
def fake_server():
    server = FakeTransferServer()
    device_plane.install_transfer_server(server)
    yield server
    device_plane.install_transfer_server(None)
    server.close()


def test_fake_transfer_server_gives_the_device_rung(params, fake_server):
    """With a transfer server, a pull that misses the in-process registry
    (another process, here simulated by unregistering the source) takes
    the device rung and gets the same blocks."""
    jp, tp = params
    p_eng, d_eng = _paged(tp), _paged(tp)
    try:
        ticket = p_eng.prefill_export(PROMPT, mig_id="t/dev").result(timeout=120)
        assert ticket["transfer_addr"] == fake_server.address()
        assert fake_server.staged_count() == ticket["n_blocks"]
        host = [disagg.pull_block(ticket, b) for b in range(ticket["n_blocks"])]
        assert {r for _, r in host} == {"host"}
        data_plane.unregister_kv_block_source("t/dev")
        before = device_plane.stats.snapshot()
        dev = [disagg.pull_block(ticket, b) for b in range(ticket["n_blocks"])]
        assert {r for _, r in dev} == {"device"}
        after = device_plane.stats.snapshot()
        assert after["ici_pulls"] == before["ici_pulls"] + ticket["n_blocks"]
        # the migration's blocks rode one connection
        assert after["connects"] == before["connects"] + 1
        assert fake_server.connections_accepted == 1
        for (a, _), (b, _) in zip(host, dev):
            assert a.dtype == b.dtype and torch.equal(a, b)
        out = d_eng.adopt_migration(ticket, {i: a for i, (a, _) in enumerate(dev)},
                                    max_tokens=8).future.result(timeout=120)
        assert out == _reference(jp, PROMPT, 8)
        assert fake_server.staged_count() == 0  # each offer consumed by its pull
        with pytest.raises(disagg.KVMigrationError) as exc:  # pulled once, gone
            disagg.pull_block(ticket, 0)
        assert exc.value.stage == "staging"
        assert p_eng.release_migration("t/dev")
        _assert_no_leak(p_eng)
        _assert_no_leak(d_eng)
    finally:
        p_eng.shutdown()
        d_eng.shutdown()


def test_release_withdraws_unpulled_device_offers(params, fake_server):
    _, tp = params
    p_eng = _paged(tp)
    try:
        ticket = p_eng.prefill_export(PROMPT, mig_id="t/wd").result(timeout=120)
        assert fake_server.staged_count() == ticket["n_blocks"]
        assert p_eng.release_migration("t/wd")
        assert fake_server.staged_count() == 0
        refusing = FakeTransferServer(refuse_pulls=True)
        device_plane.install_transfer_server(refusing)
        try:
            ticket = p_eng.prefill_export(PROMPT, mig_id="t/ref").result(timeout=120)
            data_plane.unregister_kv_block_source("t/ref")
            with pytest.raises(disagg.KVMigrationError) as exc:  # refused: a typed error
                disagg.pull_block(ticket, 0)
            assert exc.value.stage == "staging"
            assert p_eng.release_migration("t/ref")
        finally:
            refusing.close()
        _assert_no_leak(p_eng)
    finally:
        p_eng.shutdown()


@pytest.mark.parametrize("kind", ["cuda_ipc", "fake"])
def test_stalled_peer_ends_in_a_typed_error(kind, monkeypatch):
    """A peer that accepts the connection and then never answers (a hung
    producer) does not hang the decode caller: each read of the device
    rung waits at most ``Config.kv_migration_pull_timeout_s``, then the
    pull fails and the ladder ends in ``KVMigrationError(stage="staging")``."""
    import socket

    from ray_tpu_torch.core.config import reset_config

    stalled = socket.create_server(("127.0.0.1", 0))  # listens, never accepts
    server = device_plane.CudaIpcTransferServer() if kind == "cuda_ipc" else FakeTransferServer()
    device_plane.install_transfer_server(server)
    monkeypatch.setenv("RAY_TPU_KV_MIGRATION_PULL_TIMEOUT_S", "0.25")
    reset_config()
    try:
        host, port = stalled.getsockname()
        ticket = {"mig_id": "t/stall", "transfer_addr": f"{host}:{port}",
                  "block_shape": [2, 2, 16, 2, 8], "block_dtype": "float32"}
        t0 = time.monotonic()
        with pytest.raises(disagg.KVMigrationError) as exc:
            disagg.pull_block(ticket, 0)
        assert exc.value.stage == "staging"
        assert 0.2 < time.monotonic() - t0 < 5
    finally:
        device_plane.install_transfer_server(None)
        server.close()
        stalled.close()
        reset_config()


def test_staged_block_survives_its_page_reuse(params):
    """The staged blocks are copies: after the pages go back to the pool and
    another prompt is written into them, the staged bytes are unchanged."""
    _, tp = params
    p_eng = _paged(tp, max_batch_size=1, kv_num_blocks=3)  # 2 usable pages
    try:
        ticket = p_eng.prefill_export(PROMPT, mig_id="t/copy").result(timeout=120)
        staged = [p_eng.fetch_staged_block("t/copy", b).clone() for b in range(2)]
        pages = set(p_eng._prefix.match(PROMPT)[0]) | {1, 2}
        assert p_eng.flush_prefix_cache() >= 1  # the prompt's pages are free again
        other = [(5 * i + 1) % CFG.vocab_size for i in range(19)]
        p_eng.generate(other, max_tokens=2)  # written into the same pages
        reused = [torch.stack([p_eng._cache["k"][:, p], p_eng._cache["v"][:, p]])
                  for p in sorted(pages)]
        assert not any(torch.equal(r, s) for r in reused for s in staged)
        for b in range(2):
            assert torch.equal(p_eng.fetch_staged_block("t/copy", b), staged[b])
            assert torch.equal(disagg.pull_block(ticket, b)[0], staged[b])
        assert p_eng.release_migration("t/copy")
        _assert_no_leak(p_eng)
    finally:
        p_eng.shutdown()


# --------------------------------------------------------------------------
# the server's disaggregated halves
# --------------------------------------------------------------------------
def test_server_disagg_halves_match_jax(params):
    jp, tp = params
    request = {"prompt": PROMPT, "max_tokens": 7}
    srv_p = LLMServer(lambda: (CFG, tp), device="cpu", max_batch_size=2, max_seq_len=64,
                      role="prefill")
    srv_d = LLMServer(lambda: (CFG, tp), device="cpu", max_batch_size=2, max_seq_len=64,
                      role="decode")
    try:
        ticket = srv_p.disagg_prefill(request, "s/1")
        resp = srv_d.disagg_decode(request, ticket)
        assert resp["tokens"] == _reference(jp, PROMPT, 7) and resp["num_generated"] == 7
        assert resp["_migration_rung"] == "host"
        events = list(srv_d.disagg_decode({**request, "stream": True}, ticket)["_stream"])
        assert [e["token"] for e in events[:-1]] == resp["tokens"]
        assert events[-1] == {"done": True, "num_generated": 7}
        assert srv_p.disagg_release("s/1") is True and srv_p.disagg_release("s/1") is False
        gone = srv_d.disagg_decode({"prompt": [9, 8, 7] * 7, "max_tokens": 2},
                                   {**ticket, "prompt": [9, 8, 7] * 7, "mig_id": "s/none"})
        assert gone["_kv_migration_error"] and gone["stage"] == "staging"
        assert srv_d.kv_free_blocks() == srv_d.engine.stats()["kv_block_pool_size"] - \
            srv_d.engine.stats()["kv_blocks_in_use"]
    finally:
        srv_p.engine.shutdown()
        srv_d.engine.shutdown()
