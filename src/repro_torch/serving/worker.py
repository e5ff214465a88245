"""Shard worker process: one frozen shard's stages behind a socket RPC.

    python -m repro_torch.serving.worker --shard-dir <group>/<i> --fd N \
        [--mode mmap] [--shard-index i] [--transport socket] \
        [--device cuda] [--plaid-json '{...}'] [--ms-json '{...}']

A :class:`~repro_torch.serving.transport.client.ShardWorkerClient`
spawns it over a socketpair and passes its end as ``--fd``. Each worker
is a shared-nothing serving process: it loads only its own
``<i>/{colbert,splade}`` subtree (its own mmap ``PagedStore`` segment,
its own SPLADE postings slice and device cache) in an interpreter of its
own, and runs its stages on ``--device`` (default ``cuda``; every worker
of a group on one card opens its own CUDA context there). Without a GPU
the default raises at start-up: a worker runs on the CPU only when asked
to (``--device cpu``).

Exposed ops, each one per-shard stage of the sharded plans. The inputs
and the stage functions are the in-process ones
(``repro_torch.core.sharded``: ``run_splade_batch``, ``shard_gather``,
``shard_exact_scores``, ``shard_candidates``, ``shard_gather_codes``,
``shard_approx``), which is the parity argument: a reply equals the
in-process shard's stage bit for bit.

* ``ping`` / ``health``      — readiness + vitals (pid, RSS, mmap segment
  bytes, served count, its device, whether it opened a CUDA context and
  the bytes its allocator holds there, the worker's side of the channel)
* ``warm {backend}``         — switch the stage-1 scorer and materialise
  the SPLADE device cache for the ``device`` backend
* ``splade``                 — shard-local stage-1 top-k
* ``score_tokens``           — residual gather of the coordinator's
  compacted selection + exact MaxSim (rerank/hybrid stages 3–4)
* ``colbert_candidates``     — IVF candidates + codes gather +
  approximate scores (PLAID stages 2–3), at the shard's width
* ``colbert_exact``          — survivor residual gather + exact scores
  (PLAID stage 4)
* ``multi {ops: […]}``       — coalesced sub-ops; one reply with an
  ok/error slot a sub-op
* ``shutdown``               — reply, then exit 0

Every result crosses as host numpy: a device tensor is copied back
before the reply. A compute error becomes an ``{"ok": False}`` reply and
never ends the worker. SIGTERM asks for a graceful drain: the op in
flight finishes and its reply is sent before the process exits 0;
SIGKILL shows at the client as EOF (``ShardWorkerDied``).

Names, ops, replies and the wire bytes are the JAX package's
``serving/worker.py``, for frozen shards over the socket channel. One
difference: ``colbert_candidates`` cuts the candidate matrix to the
densest row's count (the port's in-process stage), not to a pow2 bucket
of at least 8; every real candidate and its score are the same. The
live ops (``live_sync``, ``live_reload``) reply with an error that
names ROADMAP item 3b-v; the shared-memory transport (``--transport
shm``, ``--arena``) is ROADMAP item 3b-i-b, and a standalone worker
(``--port``, :func:`spawn_standalone`) item 3b-vi.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import sys
import time
import traceback

# torch and the index load in main(), after the arguments are checked:
# the client takes the first ping reply as the readiness barrier, so
# everything heavy (torch, the CUDA context, the shard's files) happens
# before that reply, and importing this module starts nothing.

LIVE_OPS = ("live_sync", "live_reload")
RING_SLICE = "the shared-memory ring (ROADMAP item 3b-i-b)"
STANDALONE_SLICE = "standalone workers (ROADMAP item 3b-vi)"


class _WorkerState:
    def __init__(self, retriever, shard_index: int):
        self.retr = retriever
        self.shard = shard_index
        self.served = 0
        self.t_start = time.monotonic()
        self.draining = False
        self.channel = None            # set by serve_connection


def _handle(state: _WorkerState, op: str, payload: dict):
    import torch

    from repro_torch.common import HostCopy
    from repro_torch.core import sharded
    from repro_torch.core.store import rss_bytes

    retr = state.retr
    sr = retr.searcher

    if op == "ping":
        return {"pid": os.getpid(), "shard": state.shard, "ready": True}

    if op == "health":
        h = {"pid": os.getpid(), "shard": state.shard,
             "rss_bytes": rss_bytes(),
             "pool_bytes": sr.index.store.total_bytes(),
             "n_docs": retr.splade.n_docs,
             "served": state.served,
             "uptime_s": time.monotonic() - state.t_start,
             "access": sr.index.store.stats.snapshot(),
             # the worker's own view of the card: a context of its own
             # and the bytes its allocator holds there (0 on the CPU)
             "device": str(retr.device),
             "cuda_initialized": torch.cuda.is_initialized(),
             "device_allocated_bytes": (
                 torch.cuda.memory_allocated(retr.device)
                 if retr.device.type == "cuda" else 0)}
        if state.channel is not None:
            # the worker's view of the channel (its bytes_sent is the
            # client's bytes_recv), keyed apart from the client's fields
            h["worker_transport"] = state.channel.stats()
        return h

    if op == "warm":
        backend = payload.get("backend", "host")
        retr.set_splade_backend(backend)
        if backend != "host":
            retr.splade_device_cache()
        return {"warmed": backend}

    if op == "splade":
        # the in-process group's shard stage 1: shard-local postings and
        # top-k; the coordinator remaps to global pids and merges
        pids, scores = retr.run_splade_batch(
            list(payload["term_ids"]), list(payload["term_weights"]),
            int(payload["k"]), backend=payload.get("backend"), live=False)
        return {"pids": pids, "scores": scores}

    if op in ("score_tokens", "colbert_exact"):
        # the residual gather of the coordinator's compacted selection
        # and one decompress_maxsim launch, copied back before the reply
        s = sharded.shard_gather(retr, payload["sel"])
        (scores,) = HostCopy(sharded.shard_exact_scores(
            retr, payload["q"], payload["q_valid"], s)).wait()
        return {"scores": scores}

    if op == "colbert_candidates":
        # PLAID stages 2-3 on this shard's IVF slice at its width; the
        # raw approximate scores go back unsorted (the survivors are
        # chosen over the whole group at the coordinator)
        s = sharded.shard_gather_codes(
            retr, sharded.shard_candidates(retr, payload["cids"]))
        a = sharded.shard_approx(retr, payload["scores_c"],
                                 payload["q_valid"], s)
        return {"cand": a["cand_np"], "approx": a["approx_np"],
                "n_real": (a["cand_np"] >= 0).sum(axis=1)}

    if op in LIVE_OPS:
        raise NotImplementedError(
            f"{op}: a worker's live ops are not ported yet (ROADMAP item "
            f"3b-v); this worker serves a frozen shard")

    raise ValueError(f"unknown RPC op {op!r}")


def _run_op(state: _WorkerState, op: str, payload) -> dict:
    """One op → one ``{"ok": …}`` reply dict; compute errors are
    reported, never fatal."""
    try:
        result = _handle(state, op, payload or {})
        state.served += 1
        return {"ok": True, "result": result}
    except Exception:                    # compute error ≠ worker death
        return {"ok": False, "error": traceback.format_exc()}


def serve_connection(channel, state: _WorkerState):
    """Request loop: one op at a time, FIFO replies, per-op errors
    reported (never fatal), SIGTERM drained between ops.

    A ``multi`` op carries a list of coalesced sub-ops; each gets its
    own ok/error slot in the one reply, so one bad sub-op never fails
    its neighbours."""
    state.channel = channel
    channel.sock.setblocking(True)
    while not state.draining:
        try:
            # the channel's pump (not a socket timeout) paces the drain
            # poll: partial frames persist in its buffer across slices,
            # and frames already buffered decode without touching the
            # socket
            msg = channel.pump(0.5)
        except (ConnectionError, OSError):
            return                       # the client went away
        except ValueError:
            # an undecodable frame: the stream is desynced. That is the
            # connection's fault, not the worker's: drop the connection
            return
        if msg is None:
            continue
        op = msg.get("op", "")
        if op == "multi":
            ops = (msg.get("payload") or {}).get("ops") or []
            reply = {"ok": True, "result": {
                "replies": [_run_op(state, sub.get("op", ""),
                                    sub.get("payload")) for sub in ops]}}
        else:
            reply = _run_op(state, op, msg.get("payload"))
        try:
            channel.send(reply)
        except (ConnectionError, OSError):
            return
        if op == "shutdown":
            return


def spawn_standalone(*args, **kwargs):
    """A standalone worker listening on a TCP port (the JAX package's
    ``--port`` mode) is not ported yet."""
    raise NotImplementedError(f"spawn_standalone: {STANDALONE_SLICE}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="One frozen shard's stages behind a socket RPC.")
    ap.add_argument("--shard-dir", required=True,
                    help="this shard's subtree: <dir>/{colbert,splade}")
    ap.add_argument("--shard-index", type=int, default=0)
    ap.add_argument("--mode", default="mmap", choices=["mmap", "ram"])
    ap.add_argument("--fd", type=int, default=None,
                    help="inherited socketpair fd (client-spawned)")
    ap.add_argument("--port", type=int, default=None,
                    help=f"standalone mode: {STANDALONE_SLICE}")
    ap.add_argument("--transport", default="socket",
                    choices=["socket", "shm"],
                    help=f"socket: in-frame segments; shm: {RING_SLICE}")
    ap.add_argument("--arena", default=None, help=f"shm: {RING_SLICE}")
    ap.add_argument("--device", default="cuda",
                    help="where the shard's stages run (cuda or cpu)")
    ap.add_argument("--plaid-json", default="{}")
    ap.add_argument("--ms-json", default="{}")
    args = ap.parse_args(argv)
    if args.port is not None:
        ap.error(f"--port: {STANDALONE_SLICE} are not ported yet")
    if args.transport == "shm" or args.arena is not None:
        ap.error(f"--transport shm / --arena: {RING_SLICE} is not ported "
                 f"yet; use --transport socket")
    if args.fd is None:
        ap.error("--fd is required")

    # heavy imports after the arguments are checked; the client's first
    # ping waits until the shard is loaded
    from repro_torch.core.multistage import MultiStageParams
    from repro_torch.core.plaid import PlaidParams
    from repro_torch.core.sharded import load_shard
    from repro_torch.serving.transport import StreamChannel

    retr = load_shard(
        args.shard_dir, mode=args.mode,
        plaid_params=PlaidParams(**json.loads(args.plaid_json)),
        multistage_params=MultiStageParams(**json.loads(args.ms_json)),
        device=args.device)
    state = _WorkerState(retr, args.shard_index)

    def on_sigterm(signum, frame):
        # graceful drain: finish (and answer) the op in flight, then
        # exit; the loop checks the flag between requests
        state.draining = True

    signal.signal(signal.SIGTERM, on_sigterm)

    channel = StreamChannel(socket.socket(fileno=args.fd))
    try:
        serve_connection(channel, state)
    finally:
        channel.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
