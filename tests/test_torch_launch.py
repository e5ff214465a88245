"""The port's launcher ``python -m repro_torch.launch.serve`` and
``examples/serve_concurrent_torch.py`` against the JAX package's, on the
CPU.

- The launcher's flags are the JAX launcher's, without the shard and
  replica flags (``--shards`` … ``--hedge-floor-ms``, each an argparse
  error here) and with ``--device``; same defaults, types and choices,
  except ``--splade-backend``'s (``host``, ``device``).
- ``build_or_load`` on a directory holding the ``built_index`` fixture
  and the JAX-built SPLADE index of ``small_corpus``: the four methods'
  answers meet the parity bar against the JAX ``build_or_load``'s, in
  ``mmap`` and ``ram`` mode.
- ``--port 0 --live --device cpu`` in a child process on a copy of that
  directory, against a JAX ``RetrievalServer`` over the JAX
  ``build_or_load`` on its own copy (a compaction writes beside the
  index it compacts): every admin reply equals the JAX reply, the
  queries after each mutation meet the parity bar; after SIGTERM the
  child exits 0 and the port refuses connections.
- The bounded load on the built-in corpus (``--index-dir`` empty): exit
  0, the JAX launcher's report lines in its order, 0 failed, the trace's
  counts the JAX ``zipf_trace``'s; a ``--replay`` file wrapped and
  resized as the JAX launcher does.
- Without ``--device cpu`` the launcher and the example raise "no CUDA
  device" before serving anything.
- The listen backlog: with nothing accepting, 64 handshakes complete on
  the port's ``TCPRetrievalServer``, and the JAX front's backlog of 5
  completes fewer (the documented difference).
- The example at ``--device cpu --n 16 --max-batch 4 --tcp``.

Every child process gets ``CUDA_VISIBLE_DEVICES=""``,
``OMP_NUM_THREADS=1``, a bounded wait and a kill in a ``finally``; an
autouse fixture fails a test that leaves a child process, a serve,
handler, worker, pipeline or compactor thread. No assertion reads the
wall clock, except the bounded handshake count.
"""

import argparse
import json
import os
import pathlib
import re
import select
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np
import pytest

import repro.launch.serve as jlaunch
from repro.index.splade_index import build_splade_index as j_build_splade
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.loadgen import load_trace as j_load_trace
from repro.serving.loadgen import zipf_trace as j_zipf_trace
from repro.serving.server import RetrievalServer as JServer
from repro.serving.server import TCPRetrievalServer as JTCPServer
from repro_torch.launch import serve as launch
from repro_torch.serving.server import RetrievalServer, TCPRetrievalServer
from repro_torch.testing import REF_MARGIN, assert_topk_match

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
TIMEOUT = 120.0         # seconds: the bound on every wait for a child
HOST_ADDR = "127.0.0.1"
METHODS = ("colbert", "splade", "rerank", "hybrid")
# the JAX launcher's single-index flags, in its order
JAX_FLAGS = ("--index-dir", "--mode", "--method", "--threads",
             "--splade-backend", "--splade-max-df", "--rerank-backend",
             "--max-batch", "--batch-timeout-ms", "--latency-slo-ms",
             "--pipeline", "--pipeline-depth", "--pipeline-workers",
             "--arrival-rate", "--cache-exact", "--cache-stage1",
             "--admission-slo-ms", "--shed-factor", "--skew", "--replay",
             "--live", "--live-compact-every", "--port", "--qps", "--n")
# its shard and replica flags, which go with the port's sharding
SHARD_FLAGS = ("--shards", "--shard-workers", "--shard-transport",
               "--arena-bytes", "--replicas", "--replica-endpoints",
               "--allow-degraded", "--op-deadline-ms", "--hedge-factor",
               "--hedge-floor-ms")
# the bounded load's report lines, as the JAX launcher prints them
REPORT = (
    r"serving \(mmap index, 1 thread\(s\), stage1=host, rerank=fused, "
    r"pipeline_depth=1, shards=1 \[thread workers\]\); pool=[\d.]+ MB",
    r"offered [\d.]+ QPS → achieved [\d.]+; p50 [\d.]+ ms, p95 [\d.]+ ms, "
    r"p99 [\d.]+ ms",
    r"trace: \d+ unique / \d+ repeats; outcomes: \d+ cache hits, \d+ "
    r"degraded, \d+ shed, \d+ failed",
    r"caches: exact \d+h/\d+m \(size \d+/64\), stage1 0h/0m \(size 0/0\)",
    r"mmap working set: [\d.]+% of pool",
)
TRACE = re.compile(r"trace: (\d+) unique / (\d+) repeats; outcomes: (\d+) "
                   r"cache hits, (\d+) degraded, (\d+) shed, (\d+) failed")


# -- children and threads ----------------------------------------------------

def _children() -> set:
    """Pids of this process's live children, from ``/proc``."""
    out = set()
    me = os.getpid()
    for stat in pathlib.Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != "Z":
            out.add(int(stat.parent.name))
    return out


def _ours(t: threading.Thread) -> bool:
    return (t.name.startswith(("tcp-serve", "worker-", "pipe-",
                               "live-compactor"))
            or "process_request_thread" in t.name)


@pytest.fixture(autouse=True)
def nothing_left_running():
    """No child process, serve, handler, worker, pipeline or compactor
    thread started by the test outlives it."""
    threads, kids = set(threading.enumerate()), _children()
    yield
    left = []
    for t in threading.enumerate():
        if t in threads or not _ours(t):
            continue
        t.join(timeout=TIMEOUT)
        if t.is_alive():
            left.append(t.name)
    assert not left, f"threads left running: {left}"
    assert not _children() - kids, "a child process outlived its test"


class _Child:
    """A launcher or example process on the CPU: its output into files,
    a bounded wait, a kill in ``stop``."""

    def __init__(self, argv, tmp: pathlib.Path, name: str):
        tmp.mkdir(parents=True, exist_ok=True)
        self.out_path, self.err_path = (tmp / f"{name}.out",
                                        tmp / f"{name}.err")
        env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1", TMPDIR=str(tmp))
        with open(self.out_path, "w") as out, open(self.err_path, "w") as err:
            self.proc = subprocess.Popen([sys.executable, *map(str, argv)],
                                         cwd=ROOT, env=env, stdout=out,
                                         stderr=err)

    @property
    def out(self) -> str:
        return self.out_path.read_text()

    @property
    def err(self) -> str:
        return self.err_path.read_text()

    def port(self) -> int:
        """The port the launcher printed (``RETRIEVAL_PORT=``)."""
        for _ in range(int(TIMEOUT / 0.05)):
            m = re.search(r"^RETRIEVAL_PORT=(\d+)$", self.out, re.M)
            if m:
                return int(m.group(1))
            if self.proc.poll() is not None:
                break
            time.sleep(0.05)
        raise AssertionError(f"no RETRIEVAL_PORT line:\n{self.out}\n"
                             f"{self.err[-3000:]}")

    def wait(self) -> int:
        try:
            return self.proc.wait(timeout=TIMEOUT)
        finally:
            self.stop()

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=TIMEOUT)


def _run(argv, tmp: pathlib.Path, name: str) -> _Child:
    """Run a child to its end."""
    child = _Child(argv, tmp, name)
    child.wait()
    return child


def _launcher(*flags) -> list:
    return ["-m", "repro_torch.launch.serve", *flags]


def _refused(port: int) -> bool:
    try:
        socket.create_connection((HOST_ADDR, port), timeout=TIMEOUT).close()
    except ConnectionRefusedError:
        return True
    return False


class _Client:
    """One persistent connection: a request line out, its reply in."""

    def __init__(self, port: int):
        self.sock = socket.create_connection((HOST_ADDR, port),
                                             timeout=TIMEOUT)
        self.rfile = self.sock.makefile("rb")

    def ask(self, payload: dict) -> dict:
        self.sock.sendall((json.dumps(payload) + "\n").encode())
        return json.loads(self.rfile.readline())

    def close(self):
        self.rfile.close()
        self.sock.close()


# -- (1) the flags -----------------------------------------------------------

class _Parsed(Exception):
    pass


@pytest.fixture(scope="module")
def jax_parser():
    """The JAX launcher's parser, caught as its ``main`` parses."""
    caught = {}

    def grab(self, args=None, namespace=None):
        caught["parser"] = self
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(_Parsed):
            jlaunch.main()
    return caught["parser"]


def _actions(parser) -> dict:
    return {a.option_strings[-1]: a for a in parser._actions
            if a.option_strings and a.dest != "help"}


def test_flags_are_the_jax_launchers_without_shards(jax_parser):
    jax = list(_actions(jax_parser))
    ours = list(_actions(launch.build_parser()))
    assert [f for f in jax if f not in SHARD_FLAGS] == list(JAX_FLAGS)
    assert set(SHARD_FLAGS) <= set(jax)
    assert sorted(ours) == sorted(JAX_FLAGS + ("--device",))


@pytest.mark.parametrize("flag", JAX_FLAGS)
def test_flag_default_type_and_choices(jax_parser, flag):
    theirs = _actions(jax_parser)[flag]
    ours = _actions(launch.build_parser())[flag]
    assert type(ours) is type(theirs)
    for key in ("dest", "default", "type", "nargs", "const", "required"):
        assert getattr(ours, key) == getattr(theirs, key), key
    if flag == "--splade-backend":
        assert list(theirs.choices) == ["host", "jax", "pallas"]
        assert list(ours.choices) == ["host", "device"]
    else:
        assert ours.choices == theirs.choices


def test_device_flag_defaults_to_the_card():
    dev = _actions(launch.build_parser())["--device"]
    assert dev.default == "cuda" and dev.type is None


@pytest.mark.parametrize("flag", SHARD_FLAGS)
def test_shard_flags_are_refused(flag, capsys):
    with pytest.raises(SystemExit) as e:
        launch.build_parser().parse_args([flag, "2"])
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


# -- (2) build_or_load -------------------------------------------------------

@pytest.fixture(scope="module")
def index_root(built_index, small_corpus, tmp_path_factory):
    """``colbert/`` (the ``built_index`` fixture) and ``splade/`` (the
    JAX-built SPLADE index of ``small_corpus``) in one directory."""
    c = small_corpus
    root = tmp_path_factory.mktemp("launch_index")
    shutil.copytree(built_index, root / "colbert")
    j_build_splade(c["doc_term_ids"], c["doc_term_weights"], c["cfg"].vocab,
                   c["cfg"].n_docs).save(root / "splade")
    return root


@pytest.fixture(scope="module", params=["mmap", "ram"])
def loaded(request, index_root):
    mode = request.param
    ours = launch.build_or_load(str(index_root), mode, device="cpu")
    theirs = jlaunch.build_or_load(str(index_root), mode)
    return mode, ours, theirs


@pytest.mark.parametrize("method", METHODS)
def test_build_or_load_answers_equal_the_jax_launchers(loaded, small_corpus,
                                                       method):
    mode, (corpus, index, retr), (_, jindex, jretr) = loaded
    assert corpus is None
    assert index.store.mode == mode and index.n_docs == jindex.n_docs
    assert retr.device.type == "cpu"
    assert retr.params.first_k == jretr.params.first_k == 200
    assert retr.searcher.params.candidate_cap == 1024
    q = dict(q_embs=list(small_corpus["q_embs"][:8]),
             term_ids=list(small_corpus["q_term_ids"][:8]),
             term_weights=list(small_corpus["q_term_weights"][:8]))
    pids, scores = retr.search_batch(method, k=10, **q)
    jpids, jscores = jretr.search_batch(method, k=10 + REF_MARGIN, **q)
    assert_topk_match(np.asarray(jscores), np.asarray(jpids), scores, pids,
                      what=f"{mode} {method}")


# -- (3) the live launcher over TCP ------------------------------------------

def _query(corpus, qid, i, method, k):
    return {"qid": qid, "method": method, "k": k,
            "q_emb": corpus["q_embs"][i].tolist(),
            "term_ids": corpus["q_term_ids"][i].tolist(),
            "term_weights": corpus["q_term_weights"][i].tolist()}


def _live_lines(corpus):
    """(name, payload) in the order sent: queries on the clean index, two
    upserts, queries, deletes of a base pid, a delta pid and an unknown
    pid, queries, ``live_stats`` and ``health``, a compaction, again
    ``live_stats`` and ``health``, queries; each query at k and at k +
    ``REF_MARGIN`` (the reference's depth)."""
    n = corpus["cfg"].n_docs

    def upsert(j):
        return {"op": "upsert", "doc_emb": corpus["doc_embs"][j].tolist(),
                "doc_len": int(corpus["doc_lens"][j]),
                "term_ids": corpus["doc_term_ids"][j].tolist(),
                "term_weights": corpus["doc_term_weights"][j].tolist()}

    def queries(tag, i):
        return [(f"{tag}_{m}{deep}", _query(corpus, 100 + i, i, m,
                                            10 + deep))
                for m in METHODS for deep in (0, REF_MARGIN)]

    return (queries("clean", 0)
            + [("upsert_0", upsert(0)), ("upsert_1", upsert(1))]
            + queries("after_upserts", 1)
            + [("delete_base", {"op": "delete", "pid": 3}),
               ("delete_delta", {"op": "delete", "pid": n + 1}),
               ("delete_unknown", {"op": "delete", "pid": n + 99})]
            + queries("after_deletes", 2)
            + [("live_stats_dirty", {"op": "live_stats"}),
               ("health_dirty", {"op": "health"}),
               ("compact", {"op": "compact"}),
               ("live_stats_compacted", {"op": "live_stats"}),
               ("health_compacted", {"op": "health"})]
            + queries("after_compact", 3))


LIVE_ADMIN = ("upsert_0", "upsert_1", "delete_base", "delete_delta",
              "delete_unknown", "live_stats_dirty", "health_dirty",
              "compact", "live_stats_compacted", "health_compacted")
LIVE_QUERIES = tuple(f"{tag}_{m}" for tag in ("clean", "after_upserts",
                                              "after_deletes",
                                              "after_compact")
                     for m in METHODS)


@pytest.fixture(scope="module")
def live_launch(index_root, small_corpus, tmp_path_factory):
    """The live lines sent to the port's launcher (a child process) and to
    a JAX front over the JAX ``build_or_load``, each on its own copy of
    the index; then SIGTERM to the child. → {"ours", "theirs": name →
    reply, "exit": the child's exit code, "refused": the port after}."""
    lines = _live_lines(small_corpus)
    root = tmp_path_factory.mktemp("live_launch")
    for name in ("ours", "theirs"):
        shutil.copytree(index_root, root / name)
    out = {}
    child = _Child(_launcher("--index-dir", root / "ours", "--live",
                             "--port", 0, "--device", "cpu"),
                   root / "tmp", "live")
    try:
        port = child.port()
        conn = _Client(port)
        try:
            out["ours"] = {n: conn.ask(p) for n, p in lines}
        finally:
            conn.close()
        child.proc.send_signal(signal.SIGTERM)
        out["exit"] = child.proc.wait(timeout=TIMEOUT)
        out["refused"] = _refused(port)
        out["stdout"] = child.out
    finally:
        child.stop()

    _, _, jretr = jlaunch.build_or_load(str(root / "theirs"), "mmap")
    jretr.enable_live()
    server = JServer(JEngine(jretr))
    server.start()
    serving = None
    try:
        tcp = server.serve_tcp(HOST_ADDR, 0)
        serving = threading.Thread(target=tcp.serve_forever,
                                   name="tcp-serve-jax", daemon=True)
        serving.start()
        conn = _Client(server.tcp_port)
        try:
            out["theirs"] = {n: conn.ask(p) for n, p in lines}
        finally:
            conn.close()
    finally:
        server.shutdown_gracefully()
        server.tcp.server_close()
        if serving is not None:
            serving.join(timeout=TIMEOUT)
    return out


@pytest.mark.parametrize("name", LIVE_ADMIN)
def test_live_launcher_admin_reply_equals_the_jax_fronts(live_launch, name):
    ours, theirs = live_launch["ours"][name], live_launch["theirs"][name]
    if name.startswith("health"):
        assert ours["ok"] is theirs["ok"] is True
        for key in ("live", "index_generation", "n_shards"):
            assert ours["health"][key] == theirs["health"][key], key
        assert set(theirs["health"]) <= set(ours["health"])
        return
    assert ours == theirs


@pytest.mark.parametrize("name", LIVE_QUERIES)
def test_live_launcher_query_reply_matches_the_jax_fronts(live_launch, name):
    ours = live_launch["ours"][f"{name}0"]
    ref = live_launch["theirs"][f"{name}{REF_MARGIN}"]
    assert "error" not in ours, ours
    assert set(ours) == set(live_launch["theirs"][f"{name}0"])
    assert_topk_match(np.asarray(ref["scores"], np.float32),
                      np.asarray(ref["pids"]),
                      np.asarray(ours["scores"], np.float32),
                      np.asarray(ours["pids"]), what=name)


def test_live_launcher_drains_on_sigterm(live_launch, small_corpus):
    assert live_launch["exit"] == 0
    assert live_launch["refused"]
    ours, n = live_launch["ours"], small_corpus["cfg"].n_docs
    assert ours["upsert_1"]["pid"] == n + 1
    assert ours["compact"]["compacted"] == 2
    assert 3 not in ours["after_compact_hybrid0"]["pids"]
    assert re.search(r"^TCP front on :\d+ \(newline-delimited JSON; SIGTERM "
                     r"or Ctrl-C to stop\)$", live_launch["stdout"], re.M)


# -- (4) the bounded load ----------------------------------------------------

@pytest.fixture(scope="module")
def bounded(tmp_path_factory):
    root = tmp_path_factory.mktemp("bounded")
    child = _run(_launcher("--device", "cpu", "--index-dir", root / "index",
                           "--n", 24, "--max-batch", 8, "--skew", 1.1,
                           "--cache-exact", 64, "--qps", 200),
                 root / "tmp", "bounded")
    return child, root


def test_bounded_load_exits_0_with_the_jax_report(bounded):
    child, root = bounded
    assert child.proc.returncode == 0, child.err[-3000:]
    lines = [ln for ln in child.out.splitlines() if ln]
    assert len(lines) == len(REPORT), lines
    for line, pat in zip(lines, REPORT):
        assert re.fullmatch(pat, line), (line, pat)
    assert (root / "index" / "colbert" / "meta.json").is_file()
    assert (root / "index" / "splade").is_dir()


def test_bounded_load_trace_is_the_jax_zipf_trace(bounded):
    child, _ = bounded
    unique, repeats, hits, degraded, shed, failed = map(
        int, TRACE.search(child.out).groups())
    trace = j_zipf_trace(24, 300, skew=1.1, seed=0)
    assert (unique, repeats) == (len(set(trace.tolist())),
                                 24 - len(set(trace.tolist())))
    assert (degraded, shed, failed) == (0, 0, 0)
    assert 0 < hits <= repeats


@pytest.mark.parametrize("n", [5, 12])
def test_replay_is_wrapped_and_resized_as_the_jax_launcher(tmp_path, n):
    trace_file = tmp_path / "replay.trace"
    trace_file.write_text("# a replay\n7\n301\n7\n\n4\n299\n1\n3\n")
    child = _run(_launcher("--device", "cpu", "--index-dir",
                           tmp_path / "index", "--replay", trace_file,
                           "--n", n, "--qps", 500),
                 tmp_path / "tmp", "replay")
    assert child.proc.returncode == 0, child.err[-3000:]
    # the JAX launcher's :327-330
    trace = j_load_trace(trace_file) % 300
    trace = trace[:n] if len(trace) >= n else np.resize(trace, n)
    unique = len(set(trace.tolist()))
    assert TRACE.search(child.out).groups()[:2] == (str(unique),
                                                    str(n - unique))


@pytest.mark.parametrize("live", [False, True], ids=["frozen", "live"])
def test_bounded_load_at_depth_2_reports_the_pipeline_it_ran(tmp_path,
                                                             live):
    """A live index stays synchronous at any depth: no pipeline line
    (the JAX launcher fails there on the missing queues)."""
    child = _run(_launcher("--device", "cpu", "--index-dir",
                           tmp_path / "index", "--pipeline-depth", 2,
                           "--max-batch", 4, "--n", 8, "--qps", 500,
                           *(["--live"] if live else [])),
                 tmp_path / "tmp", "depth2")
    assert child.proc.returncode == 0, child.err[-3000:]
    assert "0 failed" in child.out
    overlap = re.search(r"^pipeline overlap: [\d.]+% \(stage queues: \{",
                        child.out, re.M)
    assert (overlap is None) is live


# -- (5) no GPU, no --device cpu ---------------------------------------------

@pytest.mark.parametrize("argv", [
    _launcher("--port", 0), _launcher("--n", 2),
    ["examples/serve_concurrent_torch.py", "--n", 2]],
    ids=["launcher_port", "launcher_bounded", "example"])
def test_without_a_gpu_the_entry_points_raise(tmp_path, argv):
    child = _run(argv, tmp_path, "nocuda")
    assert child.proc.returncode != 0
    assert "no CUDA device" in child.err
    assert "RETRIEVAL_PORT" not in child.out
    assert "serving (" not in child.out and "capacity" not in child.out


# -- (6) the listen backlog --------------------------------------------------

def _handshakes(port: int, n: int = 64, within: float = 1.0) -> int:
    """Start ``n`` connects at once; → how many completed their
    handshake within ``within`` seconds."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.setblocking(False)
            s.connect_ex((HOST_ADDR, port))
            socks.append(s)
        waiting, done = set(socks), 0
        deadline = time.monotonic() + within
        while waiting:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            _, ready, _ = select.select([], list(waiting), [], left)
            for s in ready:
                waiting.discard(s)
                done += s.getsockopt(socket.SOL_SOCKET,
                                     socket.SO_ERROR) == 0
        return done
    finally:
        for s in socks:
            s.close()


def test_the_ports_front_completes_64_handshakes_unaccepted():
    tcp = TCPRetrievalServer((HOST_ADDR, 0), RetrievalServer(None))
    try:
        assert tcp.request_queue_size >= 128
        assert _handshakes(tcp.server_address[1]) == 64
    finally:
        tcp.server_close()


def test_the_jax_front_drops_handshakes_past_its_backlog():
    """The documented difference: socketserver's backlog of 5."""
    tcp = JTCPServer((HOST_ADDR, 0), JServer(None))
    try:
        assert tcp.request_queue_size == 5
        assert 0 < _handshakes(tcp.server_address[1]) < 64
    finally:
        tcp.server_close()


# -- (7) the example ---------------------------------------------------------

def test_the_example_serves_on_the_cpu(tmp_path):
    child = _run(["examples/serve_concurrent_torch.py", "--device", "cpu",
                  "--n", 16, "--max-batch", 4, "--tcp"], tmp_path,
                 "example")
    assert child.proc.returncode == 0, child.err[-3000:]
    out = child.out.splitlines()
    assert re.match(r"service time [\d.]+ ms → capacity ≈ [\d.]+ QPS \(1 "
                    r"thread\(s\), max_batch=4\)$", out[1])
    rows = [ln for ln in out if re.fullmatch(
        r"\s*[\d.]+/s\s+[\d.]+ms\s+[\d.]+ms\s+[\d.]+ms\s+[\d.]+/s", ln)]
    assert len(rows) == 4
    reply = next(ln for ln in out if ln.startswith("response: "))
    assert re.match(r"response: \{'qid': 0, 'pids': \[\d+, \d+, \d+, \d+, "
                    r"\d+\], 'latency': ", reply)
    assert out[-1] == "drained + stopped cleanly."
