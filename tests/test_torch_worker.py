"""Shard worker processes of the port on the CPU: ``repro_torch.serving.
worker`` behind ``ShardWorkerClient`` over the socket channel.

The index of the ``built_index`` fixture (with a SPLADE index the JAX
package built beside it) is split into 2 shards by the port's
``split_index_tree``; one CPU worker a shard is spawned once for the
module. For the inputs that the in-process group's plan feeds its shard
stages (a batch of ``splade``, ``rerank`` and ``hybrid`` with each
stage-1 backend, and ``colbert``), every worker reply equals the
in-process shard's stage bit for bit: dtype, shape and bytes, -inf pads
included (``chip_smoke.worker_ops`` builds the payloads and the wanted
replies; ``chip_smoke.hold_worker_reply`` holds them). Across the
packages, the JAX package's ``repro.serving.worker._handle`` on a JAX
retriever over the same shard directory, called in this process with the
same payloads: pids and candidates equal, scores within ``rtol=1e-5,
atol=1e-5``, and the JAX reply's candidate columns past the port's
width empty. Then the client's contracts: the ``multi`` frame's error
isolation, FIFO pipelining, death as EOF, a send onto a dead peer,
soft and per-op deadlines, ``terminate``, SIGTERM, the start-up
failures (a missing shard directory; the default ``device="cuda"``
without a GPU) and ``health``.

Every wait has a bound, and a module-scoped finalizer terminates and
reaps every worker this file spawned, also when a test fails.
"""

import importlib.util
import os
import pathlib
import signal
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.multistage import MultiStageParams as JParams
from repro.core.multistage import MultiStageRetriever as JRetriever
from repro.core.plaid import PLAIDSearcher as JSearcher
from repro.core.plaid import PlaidParams as JPlaid
from repro.index.builder import ColBERTIndex as JIndex
from repro.index.splade_index import SpladeIndex as JSplade
from repro.index.splade_index import build_splade_index as j_build_splade
from repro.serving import worker as j_worker
from repro_torch.core.multistage import MultiStageParams
from repro_torch.core.plaid import PlaidParams
from repro_torch.core.sharded import build_sharded_retriever
from repro_torch.index.builder import ColBERTIndex
from repro_torch.index.sharding import load_group, split_index_tree
from repro_torch.serving import worker
from repro_torch.serving.transport import (DeadlineExceeded,
                                           ShardWorkerClient,
                                           ShardWorkerDied, ShardWorkerError,
                                           StreamChannel)
from repro_torch.testing import assert_topk_match

ROOT = pathlib.Path(__file__).resolve().parents[1]
PLAID = dict(nprobe=8, candidate_cap=512, ndocs=128, k=50)
MS = dict(first_k=50, k=20)
B = 8                     # queries in a batch
WAIT = 60.0               # seconds: the bound on every reply and exit
SPAWNED = []              # every client this file spawned a worker with


def _load_chip_smoke():
    """``chip_smoke.py`` as a module, for phase 4l's helpers: the tests
    hold replies with the phase's own rules. Listed in ``sys.modules``
    (its dataclasses look their module up); ``sys.path`` as it was."""
    spec = importlib.util.spec_from_file_location("chip_smoke_workers",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    saved = list(sys.path)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = saved
    return module


CS = _load_chip_smoke()


def _client(shard_dir, shard_index=0, **kw):
    """A CPU worker's client over the socket channel, registered for the
    module's reaper."""
    kw = dict(dict(plaid_params=PLAID, ms_params=MS, device="cpu",
                   transport="socket", spawn_timeout_s=120,
                   call_timeout_s=WAIT), **kw)
    cli = ShardWorkerClient(shard_index, shard_dir, **kw)
    SPAWNED.append(cli)
    return cli


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.fixture(scope="module", autouse=True)
def reap_every_worker():
    """Terminate (shutdown → SIGTERM → SIGKILL) and reap every worker
    the file spawned, whatever the tests did."""
    yield
    for cli in SPAWNED:
        if cli.proc is not None:
            cli.terminate(grace_s=5)
    assert all(cli.proc is None or cli.proc.returncode is not None
               for cli in SPAWNED)


# ---------------------------------------------------------------------------
# fixtures: the group, its in-process twin, its workers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def base(tmp_path_factory, small_corpus, built_index):
    """Serve layout over ``built_index``: <base>/{colbert,splade}."""
    c = small_corpus
    root = tmp_path_factory.mktemp("torch_worker")
    (root / "base").mkdir()
    (root / "base" / "colbert").symlink_to(built_index,
                                           target_is_directory=True)
    j_build_splade(c["doc_term_ids"], c["doc_term_weights"], c["cfg"].vocab,
                   c["cfg"].n_docs).save(root / "base" / "splade")
    return root / "base"


@pytest.fixture(scope="module")
def group(base):
    return load_group(split_index_tree(base, 2,
                                       group_dir=base.parent / "S2"))


@pytest.fixture(scope="module")
def inproc(group):
    dirs, bounds = group
    return build_sharded_retriever(
        dirs, bounds, plaid_params=PlaidParams(**PLAID),
        multistage_params=MultiStageParams(**MS), device="cpu")


@pytest.fixture(scope="module")
def workers(group):
    """One CPU worker a shard, spawned at once."""
    clients, _ = CS.spawn_workers(group[0], PLAID, MS, "cpu")
    SPAWNED.extend(clients)
    return clients


@pytest.fixture(scope="module")
def batches(small_corpus):
    c = small_corpus
    splade = dict(q_embs=list(c["q_embs"][:B]),
                  term_ids=list(c["q_term_ids"][:B]),
                  term_weights=list(c["q_term_weights"][:B]))
    return {"splade": splade, "rerank": splade, "hybrid": splade,
            "colbert": dict(q_embs=list(c["q_embs"][B:2 * B]))}


@pytest.fixture(scope="module")
def ops(inproc, batches):
    """{(method, stage-1 backend): per shard, the ops and wanted
    replies} of one batch each."""
    out = {run: CS.worker_ops(inproc, run[0], run[1], **batches[run[0]])
           for run in CS.WORKER_RUNS}
    inproc.set_splade_backend("host")
    return out


@pytest.fixture(scope="module")
def jax_shards(group):
    """A JAX retriever over each shard directory, for the JAX worker's
    ``_handle`` in this process."""
    return [JRetriever(JSplade.load(d / "splade", mmap=True),
                       JSearcher(JIndex(d / "colbert", mode="mmap"),
                                 JPlaid(**PLAID)),
                       JParams(**MS))
            for d in group[0]]


# ---------------------------------------------------------------------------
# worker replies == the in-process shard stages, bit for bit
# ---------------------------------------------------------------------------

OP_CASES = [("splade", "host", 0), ("rerank", "host", 0),
            ("rerank", "host", 1), ("hybrid", "host", 0),
            ("hybrid", "host", 1), ("splade", "device", 0),
            ("colbert", None, 0), ("colbert", None, 1)]


def _op_id(case):
    method, backend, j = case
    name = ("splade", "score_tokens")[j] if method != "colbert" \
        else ("colbert_candidates", "colbert_exact")[j]
    return f"{method}-{backend or 'plaid'}-{name}"


@pytest.mark.parametrize("case", OP_CASES, ids=_op_id)
def test_reply_equals_the_in_process_stage(workers, inproc, ops, batches,
                                           case):
    method, backend, j = case
    for i, cli in enumerate(workers):
        o = ops[(method, backend)][i][j]
        got = cli.call(o["op"], o["payload"], timeout=WAIT)
        CS.hold_worker_reply(f"{_op_id(case)} shard {i}", got, o["want"],
                             o["offset"])
        if o["op"] == "splade":
            # shard-local, as the lifted stage gives them
            b = batches[method]
            want = inproc.shards[i].run_splade_batch(
                b["term_ids"], b["term_weights"], MS["first_k"],
                backend=backend, live=False)
            for g, w in zip((got["pids"], got["scores"]), want):
                assert (g.dtype, g.shape) == (w.dtype, w.shape)
                assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("method", ["splade", "rerank", "hybrid",
                                    "colbert"])
def test_a_multi_frame_answers_as_the_single_ops(workers, ops, method):
    backend = None if method == "colbert" else "host"
    for i, cli in enumerate(workers):
        mine = ops[(method, backend)][i]
        got = cli.call("multi", {"ops": [
            {"op": o["op"], "payload": o["payload"]} for o in mine]},
            timeout=WAIT)["replies"]
        assert [r["ok"] for r in got] == [True] * len(mine)
        for r, o in zip(got, mine):
            CS.hold_worker_reply(f"{method} multi {o['op']}", r["result"],
                                 o["want"], o["offset"])


def test_chip_smoke_worker_parity_on_the_cpu_group(workers, inproc,
                                                   batches):
    """Phase 4l's parity function on the 2-shard CPU group: every run's
    ops single and in one frame, bit for bit, then timed beside the op
    body run in this process."""
    try:
        figs = CS.worker_parity(workers, inproc, batches)
    finally:
        inproc.set_splade_backend("host")
    assert list(figs) == [m if b is None else f"{m}/{b}"
                          for m, b in CS.WORKER_RUNS]
    for run, per_op in figs.items():
        for op, f in per_op.items():
            assert len(f["worker_ms"]) == len(f["in_process_ms"]) == 2
            assert min(f["request_bytes"]) > 0 and min(f["reply_bytes"]) > 0


def test_stage_bits_do_not_move_with_the_thread_count(inproc, batches):
    """The child inherits the parent's environment, so it runs with the
    parent's default intra-op thread count; a reduction whose order
    followed the count would still change bits across processes. The
    shard stages' plain versions give the same bits at 1 thread and at
    the default count."""
    default = torch.get_num_threads()
    want = {m: CS.worker_ops(inproc, m, None, **batches[m])
            for m in ("rerank", "colbert")}
    try:
        torch.set_num_threads(1)
        got = {m: CS.worker_ops(inproc, m, None, **batches[m])
               for m in ("rerank", "colbert")}
    finally:
        torch.set_num_threads(default)
    for m in want:
        for w_ops, g_ops in zip(want[m], got[m]):
            for w, g in zip(w_ops, g_ops):
                CS.hold_worker_reply(f"{m} {w['op']} at 1 thread",
                                     g["want"], w["want"], None)


# ---------------------------------------------------------------------------
# across the packages: the JAX worker's _handle on the same shard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["splade", "score_tokens",
                                "colbert_candidates", "colbert_exact"])
def test_replies_meet_the_jax_workers(workers, ops, jax_shards, op):
    run = ("colbert", None) if op.startswith("colbert") \
        else ("rerank", "host")
    for i, cli in enumerate(workers):
        (o,) = [o for o in ops[run][i] if o["op"] == op]
        got = cli.call(op, o["payload"], timeout=WAIT)
        ref = j_worker._handle(j_worker._WorkerState(jax_shards[i], i), op,
                               o["payload"])
        what = f"{op} shard {i}"
        if op == "splade":
            assert_topk_match(np.asarray(ref["scores"]),
                              np.asarray(ref["pids"]), got["scores"],
                              got["pids"], what=what)
        elif op == "colbert_candidates":
            w = got["cand"].shape[1]
            cand, approx = np.asarray(ref["cand"]), np.asarray(ref["approx"])
            assert w <= cand.shape[1]
            np.testing.assert_array_equal(got["cand"], cand[:, :w])
            np.testing.assert_array_equal(got["n_real"], ref["n_real"])
            assert (cand[:, w:] == -1).all(), what
            assert np.isneginf(approx[:, w:]).all(), what
            np.testing.assert_allclose(got["approx"], approx[:, :w],
                                       rtol=1e-5, atol=1e-5, err_msg=what)
        else:
            np.testing.assert_allclose(got["scores"],
                                       np.asarray(ref["scores"]), rtol=1e-5,
                                       atol=1e-5, err_msg=what)


# ---------------------------------------------------------------------------
# the client's contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad,names", [
    ("definitely_not_an_op", "unknown RPC op"),
    ("live_sync", "3b-v"), ("live_reload", "3b-v")])
def test_a_bad_sub_op_fails_alone(workers, ops, bad, names):
    cli = workers[0]
    o = ops[("splade", "host")][0][0]
    got = cli.call("multi", {"ops": [
        {"op": "ping", "payload": {}}, {"op": bad, "payload": {}},
        {"op": "splade", "payload": o["payload"]},
        {"op": "ping", "payload": {}}]}, timeout=WAIT)["replies"]
    assert [r["ok"] for r in got] == [True, False, True, True]
    assert names in got[1]["error"]
    CS.hold_worker_reply("neighbour", got[2]["result"], o["want"],
                         o["offset"])
    with pytest.raises(ShardWorkerError, match=names):
        cli.call(bad, {}, timeout=WAIT)
    assert cli.call("ping", {}, timeout=WAIT)["pid"] == cli.pid
    assert cli.alive()


def test_pipelined_calls_resolve_to_their_own_replies(workers, inproc,
                                                      batches):
    """Ten requests in flight, waited for in reverse order: each handle
    gets its own request's reply (a query of its own, k of its own)."""
    cli, b = workers[1], batches["splade"]
    reps = [cli.call_async("splade", {
        "term_ids": [b["term_ids"][j % B]],
        "term_weights": [b["term_weights"][j % B]], "k": 5 + j,
        "backend": "host"}) for j in range(10)]
    assert cli.outstanding() == 10
    for j in reversed(range(10)):
        got = cli.wait(reps[j], timeout=WAIT)
        want = inproc.shards[1].run_splade_batch(
            [b["term_ids"][j % B]], [b["term_weights"][j % B]], 5 + j,
            backend="host", live=False)
        assert got["pids"].tobytes() == want[0].tobytes()
        assert got["scores"].tobytes() == want[1].tobytes()
    assert cli.outstanding() == 0


def test_death_is_eof_for_every_pending_handle(group):
    cli = _client(group[0][0])
    cli.spawn()
    os.kill(cli.pid, signal.SIGSTOP)         # nothing will be answered
    reps = [cli.call_async("ping", {}) for _ in range(3)]
    os.kill(cli.pid, signal.SIGKILL)
    for rep in reps:
        with pytest.raises(ShardWorkerDied):
            cli.wait(rep, timeout=WAIT)
    assert not cli.alive()
    assert cli.terminate() == -signal.SIGKILL
    assert _gone(cli.pid)


class _FakeProc:
    """A stand-in child for the ``sock`` seam: ``poll`` says whether it
    has exited."""
    pid = -1

    def __init__(self, code=None):
        self.code = code

    def poll(self):
        return self.code


def test_a_send_onto_a_dead_peer_fails_pending_without_deadlock(tmp_path):
    """A send onto a dead peer raises ShardWorkerDied and fails the
    outstanding handles, from inside the send's critical section
    (re-entrant) and without wedging on a full pipe
    (tests/test_process_group.py:116-153)."""
    cli = ShardWorkerClient(0, tmp_path / "nowhere", transport="socket",
                            device="cpu")
    a, b = socket.socketpair()
    cli.sock = a
    cli.proc = _FakeProc(-9)
    rep = cli.call_async("ping", {})         # taken by the socket buffer
    b.close()                                # the peer dies
    failures = []

    def second_send():
        try:
            # a payload larger than the buffer reaches the closed peer
            cli.call_async("x", {"big": np.zeros(1 << 22, np.uint8)})
        except ShardWorkerDied as e:
            failures.append(e)

    t = threading.Thread(target=second_send, daemon=True)
    t.start()
    t.join(timeout=10)
    a.close()
    assert not t.is_alive(), "the sender deadlocked marking the peer dead"
    assert failures
    assert rep.event.is_set() and isinstance(rep.error, ShardWorkerDied)


def test_a_soft_deadline_keeps_the_client_and_the_fifo(tmp_path):
    """A soft deadline raises ShardWorkerError and leaves the client
    alive; once the far end answers, the abandoned reply is consumed, in
    order, by the next waiter."""
    cli = ShardWorkerClient(0, tmp_path / "nowhere", transport="socket",
                            device="cpu")
    a, b = socket.socketpair()
    cli.sock = a
    cli.proc = _FakeProc()
    far = StreamChannel(b)
    try:
        first = cli.call_async("ping", {"n": 1})
        with pytest.raises(ShardWorkerError, match="soft"):
            cli.wait(first, timeout=0.2, kill_on_timeout=False)
        assert cli.alive() and cli.outstanding() == 1
        second = cli.call_async("ping", {"n": 2})
        for _ in range(2):
            msg = far.recv(timeout=WAIT)
            far.send({"ok": True, "result": msg["payload"]})
        assert cli.wait(second, timeout=WAIT) == {"n": 2}
        assert first.event.is_set()
        assert cli.wait(first, timeout=0) == {"n": 1}
        assert cli.alive() and cli.outstanding() == 0
    finally:
        far.close()
        a.close()


def test_a_per_op_deadline_raises_and_marks_the_client_dead(tmp_path):
    cli = ShardWorkerClient(0, tmp_path / "nowhere", transport="socket",
                            device="cpu")
    a, b = socket.socketpair()
    cli.sock = a
    cli.proc = _FakeProc()
    try:
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded):
            cli.call("ping", {}, timeout=WAIT, timeout_ms=100)
        assert time.monotonic() - t0 < WAIT / 2
        assert cli.dead and not cli.alive()
        with pytest.raises(ShardWorkerDied):
            cli.call_async("ping", {})
    finally:
        a.close()
        b.close()


def test_terminate_exits_0_and_reaps_once(group):
    cli = _client(group[0][1], 1)
    assert cli.spawn()["shard"] == 1
    pid = cli.pid
    assert cli.terminate() == 0
    assert _gone(pid)
    t0 = time.monotonic()
    assert cli.terminate() == 0
    assert time.monotonic() - t0 < 1.0
    assert not cli.alive()


def test_sigterm_on_an_idle_worker_exits_0(group):
    cli = _client(group[0][0])
    cli.spawn()
    pid = cli.pid
    os.kill(pid, signal.SIGTERM)
    assert cli.proc.wait(timeout=15) == 0
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
    cli.terminate()


def test_a_missing_shard_directory_fails_the_spawn(tmp_path):
    cli = _client(tmp_path / "no_such_shard")
    with pytest.raises(ShardWorkerDied, match="exit code 1"):
        cli.spawn()
    assert cli.proc.returncode == 1 and _gone(cli.pid)
    assert not cli.alive()


def test_the_default_device_needs_a_gpu(group):
    """No fallback across a process boundary: the client's default
    ``device="cuda"`` on a host without a visible GPU makes the child
    raise at start-up; ``spawn`` reports its exit code and leaves no
    child."""
    cli = ShardWorkerClient(0, group[0][0], plaid_params=PLAID,
                            ms_params=MS, transport="socket",
                            spawn_timeout_s=120, call_timeout_s=WAIT,
                            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    SPAWNED.append(cli)
    assert cli.device == "cuda"
    with pytest.raises(ShardWorkerDied, match="exit code 1"):
        cli.spawn()
    assert cli.proc.returncode == 1 and _gone(cli.pid)


def test_health_reports_each_workers_own_segment(workers, inproc, base):
    """Shared nothing: each worker maps its own segment, and the
    segments sum to the unsplit pool (tests/test_process_group.py:
    294-305)."""
    health = [cli.call("health", {}, timeout=WAIT) for cli in workers]
    for i, h in enumerate(health):
        assert list(h) == ["pid", "shard", "rss_bytes", "pool_bytes",
                           "n_docs", "served", "uptime_s", "access",
                           "device", "cuda_initialized",
                           "device_allocated_bytes", "worker_transport"]
        assert (h["pid"], h["shard"]) == (workers[i].pid, i)
        assert h["pool_bytes"] == \
            inproc.shards[i].searcher.index.store.total_bytes()
        assert h["n_docs"] == inproc.shards[i].splade.n_docs
        assert h["rss_bytes"] > 0
        # a CPU worker never opens a CUDA context
        assert (h["device"], h["cuda_initialized"],
                h["device_allocated_bytes"]) == ("cpu", False, 0)
        assert h["worker_transport"]["transport"] == "socket"
        # the worker's side of the channel: every byte the client sent
        # was read before the health op ran; its own reply is not counted
        assert h["worker_transport"]["bytes_recv"] == workers[i].bytes_sent
        assert h["worker_transport"]["bytes_sent"] < workers[i].bytes_recv
    total = ColBERTIndex(base / "colbert").store.total_bytes()
    assert sum(h["pool_bytes"] for h in health) == total
    assert max(h["pool_bytes"] for h in health) < total
    stats = workers[0].transport_stats()
    assert stats["transport"] == "socket" and stats["bytes_zero_copy"] == 0


# ---------------------------------------------------------------------------
# what is not ported yet raises and names its slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,names", [
    ({"transport": "shm"}, "3b-i-b"), ({}, "3b-i-b"),
    ({"transport": "socket", "endpoint": "127.0.0.1:1"}, "3b-vi"),
    ({"transport": "socket", "fault_spec": object()}, "3b-vi")],
    ids=["shm", "default", "endpoint", "fault_spec"])
def test_the_client_refuses_what_is_not_ported(tmp_path, kw, names):
    with pytest.raises(NotImplementedError, match=names):
        ShardWorkerClient(0, tmp_path, device="cpu", **kw)


@pytest.mark.parametrize("argv,names", [
    (["--port", "0"], "3b-vi"),
    (["--fd", "3", "--transport", "shm"], "3b-i-b"),
    (["--fd", "3", "--arena", "x.arena"], "3b-i-b")],
    ids=["port", "shm", "arena"])
def test_the_worker_refuses_what_is_not_ported(tmp_path, capsys, argv,
                                               names):
    with pytest.raises(SystemExit) as e:
        worker.main(["--shard-dir", str(tmp_path), *argv])
    assert e.value.code == 2
    assert names in capsys.readouterr().err


def test_no_ring_or_fault_module_yet():
    transport = ROOT / "src" / "repro_torch" / "serving" / "transport"
    assert not (transport / "shm.py").exists()
    assert not (transport / "faults.py").exists()
    import repro_torch.serving.transport as P
    assert not hasattr(P, "ShmChannel")
    with pytest.raises(NotImplementedError, match="3b-vi"):
        worker.spawn_standalone()
