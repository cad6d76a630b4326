"""Subprocess serving replica: a ``ServingEngine`` behind a socket
protocol (the port's copy of ``bigdl_tpu/serving/worker.py``).

A replica in its own process is a failure domain of its own: a crash is
a process death (SIGKILL included) that the fleet's supervisor observes.
``ReplicaServer`` wraps one engine; ``serving/fleet.py``'s
``SubprocessReplica`` is the client side and ``tools/torch_serve_fleet.py``
the command line that spawns workers.

Transport: by default the binary frame protocol of ``serving/
transport.py`` (persistent multiplexed connections, a digest-authed
handshake against ``BIGDL_RUN_TOKEN``, tensor frames), byte for byte the
JAX package's, so a JAX client asks a port worker and the other way
round.  ``transport="pickle"`` keeps the length-prefixed pickle wire (a
4-byte big-endian length and a pickled payload, one connection a request,
a trusted peer).  Requests are ``{"op": ..., **kwargs}``; responses
``{"ok": True, "result": ...}`` or ``{"ok": False, "error": ...,
"error_type": ...}``.  Ops:

- ``predict``  {feature, timeout} -> output tree (numpy leaves);
- ``generate`` {prompt, max_new_tokens, eos_id, timeout, temperature?,
  top_k?, top_p?, seed?} -> the generated token ids (the engine's
  continuous-batching slots; the socket answers once the sequence is
  done);
- ``probe``    {features, bucket} -> sha256 digest of the unbatched
  reference outputs (``predict_at``), the bit-for-bit fingerprint two
  processes serving one version share;
- ``health``   {} -> {status, draining, version, stats, pid}, plain
  Python;
- ``drain``    {timeout} / ``undrain`` {};
- ``capture``  {} -> a token for the live weights;
- ``stage``    {path} -> a token for a snapshot staged beside the live
  weights;
- ``stage_tree`` {params, mstate?, weight_wire?, wire_bytes?} -> a token
  for a weight tree shipped over the wire (optionally blockwise int8,
  ``transport.quantize_tree_for_wire``, dequantized here);
- ``gate``     {token} -> (ok, reason): the staged candidate's outputs on
  the probe batch must be finite;
- ``commit``   {token, version, digest}: the weights made live in place;
- ``release``  {token} / ``set_version`` {version, digest} / ``stop``.

A request's ``trace`` field (JAX's optional request-trace context) is
ignored, as a worker without tracing does in the JAX package: request
tracing waits for ROADMAP A8.  Deploy verbs run under one lock (they
mutate staging state); predict traffic is served concurrently.
"""

import hashlib
import logging
import os
import pickle
import socket
import socketserver
import struct
import threading

import numpy as np
import torch

from bigdl_tpu_torch.serving.transport import (ReplicaCallError,
                                               WireFrameError, run_token,
                                               serve_connection)
from bigdl_tpu_torch.utils.errors import UnsupportedFeatureError

log = logging.getLogger("bigdl_tpu_torch.serving")

#: refuse absurd frames instead of allocating them (a corrupt length
#: prefix must not exhaust the worker's memory)
MAX_MESSAGE_BYTES = 1 << 28


def send_msg(sock, obj):
    """One length-prefixed pickled message."""
    data = pickle.dumps(obj)
    if len(data) > MAX_MESSAGE_BYTES:
        raise WireFrameError(f"message of {len(data)} bytes exceeds the "
                             f"{MAX_MESSAGE_BYTES}-byte frame cap")
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError(
                f"peer closed mid-message ({len(buf)}/{n} bytes)")
        buf += chunk
    return buf


def recv_msg(sock):
    """The matching read: length prefix, then exactly that many bytes."""
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    if n > MAX_MESSAGE_BYTES:
        raise WireFrameError(f"frame of {n} bytes exceeds the "
                             f"{MAX_MESSAGE_BYTES}-byte cap "
                             f"(corrupt prefix?)")
    return pickle.loads(_recv_exact(sock, n))


def call(host, port, op, rpc_timeout=30.0, transport="binary",
         auth_token=None, **kwargs):
    """One request/response on a throwaway connection: the binary wire
    (``transport.call_once``) by default, the pickle wire with
    ``transport="pickle"``.  ``auth_token`` overrides the
    ``BIGDL_RUN_TOKEN`` handshake secret (not the staged-handle
    ``token=`` request field, which stays a plain kwarg).  Raises
    ``ReplicaCallError`` when the worker answered an error,
    ``ConnectionError`` / ``OSError`` when it is unreachable."""
    if transport == "binary":
        from bigdl_tpu_torch.serving.transport import call_once

        return call_once(host, port, op, rpc_timeout=rpc_timeout,
                         auth_token=auth_token, **kwargs)
    with socket.create_connection((host, int(port)),
                                  timeout=rpc_timeout) as s:
        s.settimeout(rpc_timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_msg(s, {"op": op, **kwargs})
        resp = recv_msg(s)
    if not isinstance(resp, dict) or not resp.get("ok"):
        err = (resp or {}).get("error", "malformed response")
        raise ReplicaCallError(
            f"{op} failed on worker {host}:{port}: {err}",
            error_type=(resp or {}).get("error_type"))
    return resp.get("result")


def tree_leaves(tree):
    """The leaves of a nested dict / list / tuple, in order."""
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def plain(obj):
    """``obj`` with every tensor, numpy array and numpy scalar turned into
    plain Python (lists and numbers), so nothing of torch reaches a
    reply."""
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(plain(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, (np.ndarray, np.generic)):
        return obj.tolist()
    if isinstance(obj, (torch.dtype, torch.device)):
        return str(obj)
    return obj


def _host(tree):
    """An output tree as numpy leaves (the reply's tensor frames)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def gate_staged(engine, handle, probe_features, probe_bucket=None):
    """The per-replica deploy gate: the staged candidate's outputs on the
    probe batch must be finite on the real rows (``[:n]``: a padding
    row's values are not the candidate's fault).  One implementation for
    ``fleet.InProcessReplica.gate`` and the worker's ``gate`` op."""
    if probe_features is None:
        return True, "no probe features configured"
    n = len(probe_features)
    bucket = int(probe_bucket) if probe_bucket else \
        (engine.ladder.bucket_for(n) or n)
    x = engine._form_batch(list(probe_features), bucket)
    y = engine.eval_staged(handle, x)
    bad = sum(1 for l in tree_leaves(_host(y))
              if not np.all(np.isfinite(l[:n])))
    if bad:
        return False, (f"staged candidate produced non-finite outputs "
                       f"on the probe batch ({bad} leaf/leaves)")
    return True, None


def probe_digest(engine, probe_features, bucket):
    """Bit-for-bit serving fingerprint: each probe row through the
    unbatched reference path (``predict_at`` at one fixed bucket), every
    output leaf hashed; two processes serving the same committed weights
    through the same steps give the same digest."""
    h = hashlib.sha256()
    for r in probe_features:
        for leaf in tree_leaves(_host(engine.predict_at(r, bucket))):
            h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()[:16]


def boot_from_registry(engine, registry_path):
    """Point a fresh worker at the fleet's committed version: read the
    durable registry, refuse a digest imposter, stage and commit the live
    version's snapshot -- as the int8 weight wire delivers it where the
    version was rolled out on that wire, so the worker serves what the
    rest of the fleet serves.  Returns the served ``(version, digest)``,
    or None when the registry has no live snapshot (the worker then
    serves its seeded boot weights, which the baseline version is)."""
    if registry_path is None or not os.path.exists(str(registry_path)):
        return None
    from bigdl_tpu_torch.serving.deploy import (ModelRegistry,
                                                snapshot_digest)

    reg = ModelRegistry(str(registry_path))
    live = reg.live
    if live is None or live.path is None:
        return None
    digest = snapshot_digest(live.path)
    if live.digest is not None and digest != live.digest:
        raise RuntimeError(
            f"snapshot {live.path} does not match the registry's live "
            f"version v{live.version} (digest {digest} != {live.digest});"
            f" refusing to boot a replica on an imposter")
    if live.weight_wire == "int8":
        from bigdl_tpu_torch.serving.transport import (
            dequantize_wire_tree, quantize_tree_for_wire)

        params, mstate = engine._load_snapshot_weights(
            engine._resolve_snapshot(live.path))
        engine.refresh_params(
            dequantize_wire_tree(quantize_tree_for_wire(params)),
            None if mstate is None
            else dequantize_wire_tree(quantize_tree_for_wire(mstate)))
    else:
        engine.refresh_from_snapshot(live.path)
    engine.set_serving_version(live.version, live.digest)
    return live.version, live.digest


class ReplicaServer:
    """One engine served over the socket protocol.

    >>> srv = ReplicaServer(engine, port=0, probe_features=x[:4])
    >>> srv.port                       # the port the system gave
    >>> srv.serve_forever()            # or srv.start() for a thread

    ``probe_features`` feed the ``gate`` op and the ``probe`` digest.
    ``max_handles`` bounds the token store, so a long-lived worker cannot
    keep staged weights forever (the oldest is released first).

    ``transport="binary"`` (default) serves the frame protocol with the
    digest handshake against ``token`` (default: ``BIGDL_RUN_TOKEN``; no
    token handshakes without auth); ``transport="pickle"`` the one-shot
    pickle wire.  The listener binds ``host:port`` (``127.0.0.1:0`` by
    default: the system picks a free port)."""

    def __init__(self, engine, host="127.0.0.1", port=0,
                 probe_features=None, probe_bucket=None, max_handles=8,
                 transport="binary", token=None, max_frame_bytes=None):
        if transport not in ("binary", "pickle"):
            raise ValueError(f"unknown transport {transport!r}; "
                             f"expected 'binary' or 'pickle'")
        self.engine = engine
        self.transport = transport
        self.token = token if token is not None else run_token()
        self.max_frame_bytes = max_frame_bytes
        self.probe_features = probe_features
        self.probe_bucket = int(probe_bucket) if probe_bucket \
            else (len(probe_features) if probe_features is not None else 1)
        self.max_handles = int(max_handles)
        self._handles = {}
        self._next_token = 0
        self._deploy_lock = threading.Lock()
        server = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                if server.transport == "binary":
                    serve_connection(self.request,
                                     server._handle_request,
                                     token=server.token,
                                     max_frame_bytes=
                                     server.max_frame_bytes)
                    return
                try:
                    self.request.setsockopt(socket.IPPROTO_TCP,
                                            socket.TCP_NODELAY, 1)
                    req = recv_msg(self.request)
                except Exception:
                    return                     # half-open scanner etc.
                resp = server._handle_request(req)
                try:
                    send_msg(self.request, resp)
                except Exception:
                    pass                       # client hung up

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, int(port)), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread = None

    def _handle_request(self, req):
        """One request -> one response envelope; op errors cross the wire
        typed, the worker lives."""
        try:
            return {"ok": True, "result": self._dispatch(req)}
        except Exception as e:
            log.exception("replica op %r failed",
                          req.get("op") if isinstance(req, dict) else req)
            return {"ok": False, "error": str(e)[:500],
                    "error_type": type(e).__name__}

    # ----- op dispatch ------------------------------------------------------- #
    def _dispatch(self, req):
        op = req.get("op")
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            raise ValueError(f"unknown op {op!r}")
        return fn(req)

    def _op_predict(self, req):
        y = self.engine.predict(req["feature"], timeout=req.get("timeout"))
        return _host(y)

    def _op_generate(self, req):
        # one budget for the whole call (admission and the token wait
        # draw it down together); a timed-out request is abandoned, so no
        # decode slot keeps streaming tokens nobody reads while a fleet
        # retry re-runs the prompt on a sibling
        import time
        from concurrent.futures import TimeoutError as FutureTimeoutError

        timeout = req.get("timeout")
        t0 = time.perf_counter()
        fut = self.engine.generate(
            req["prompt"],
            max_new_tokens=int(req.get("max_new_tokens", 16)),
            eos_id=req.get("eos_id"), timeout=timeout,
            temperature=float(req.get("temperature", 0.0)),
            top_k=int(req.get("top_k", 0)),
            top_p=float(req.get("top_p", 1.0)),
            seed=req.get("seed"))
        remaining = None if timeout is None \
            else max(0.0, timeout - (time.perf_counter() - t0))
        try:
            toks = fut.result(remaining)
        except FutureTimeoutError:
            self.engine._abandon(fut)
            raise
        return [int(t) for t in toks]

    def _op_probe(self, req):
        feats = req.get("features")
        if feats is None:
            feats = self.probe_features
        if feats is None:
            raise ValueError("no probe features configured on this worker")
        return probe_digest(self.engine, feats,
                            int(req.get("bucket") or self.probe_bucket))

    def _op_health(self, req):
        return plain({"status": "draining" if self.engine.draining
                      else "ok",
                      "draining": self.engine.draining,
                      "version": self.engine._version_info,
                      "stats": self.engine.stats(),
                      "pid": os.getpid()})

    def _op_drain(self, req):
        return self.engine.drain(timeout=req.get("timeout"))

    def _op_undrain(self, req):
        self.engine.undrain()
        return True

    def _op_set_version(self, req):
        self.engine.set_serving_version(req["version"], req.get("digest"))
        return True

    def _put_handle(self, handle):
        self._next_token += 1
        token = f"h{self._next_token}"
        self._handles[token] = handle
        while len(self._handles) > self.max_handles:
            evicted = next(iter(self._handles))
            del self._handles[evicted]
            log.warning("replica handle store full: released oldest "
                        "staged handle %s", evicted)
        return token

    def _op_capture(self, req):
        with self._deploy_lock:
            return self._put_handle(self.engine.capture_staged())

    def _op_stage(self, req):
        with self._deploy_lock:
            p = self.engine._resolve_snapshot(req["path"])
            params, mstate = self.engine._load_snapshot_weights(p)
            return self._put_handle(self.engine.stage_weights(params,
                                                              mstate))

    def _op_stage_tree(self, req):
        # a weight tree shipped over the wire (tensor frames, optionally
        # blockwise int8: the client quantized it with
        # transport.quantize_tree_for_wire, inverted here; an fp32 tree
        # passes through unchanged)
        from bigdl_tpu_torch.serving.transport import dequantize_wire_tree

        if req.get("src_layout") is not None:
            raise UnsupportedFeatureError(
                "stage_tree ships weights already in the serving layout; "
                "src_layout= (redistributing a checkpoint of another "
                "layout, parallel/reshard) is not ported: ROADMAP A7")
        with self._deploy_lock:
            params = dequantize_wire_tree(req["params"])
            mstate = req.get("mstate")
            if mstate is not None:
                mstate = dequantize_wire_tree(mstate)
            handle = self.engine.stage_weights(params, mstate)
            handle["weight_wire"] = req.get("weight_wire") or "fp32"
            if req.get("wire_bytes") is not None:
                handle["wire_bytes"] = int(req["wire_bytes"])
            return self._put_handle(handle)

    def _handle_of(self, req):
        token = req.get("token")
        handle = self._handles.get(token)
        if handle is None:
            raise KeyError(
                f"unknown staged-handle token {token!r} (released, "
                f"evicted, or from before a worker restart)")
        return handle

    def _op_gate(self, req):
        with self._deploy_lock:
            handle = self._handle_of(req)
            return gate_staged(self.engine, handle, self.probe_features,
                               self.probe_bucket)

    def _op_commit(self, req):
        with self._deploy_lock:
            handle = self._handle_of(req)
            if req.get("wire_bytes") is not None:
                # the client measured what crossed the wire for this
                # staged tree
                handle["wire_bytes"] = int(req["wire_bytes"])
                if req.get("weight_wire"):
                    handle["weight_wire"] = req["weight_wire"]
            self.engine.commit_staged(handle, version=req.get("version"),
                                      digest=req.get("digest"))
            return True

    def _op_release(self, req):
        with self._deploy_lock:
            self._handles.pop(req.get("token"), None)
            return True

    def _op_stop(self, req):
        threading.Thread(target=self._server.shutdown,
                         daemon=True).start()
        return True

    # ----- lifecycle --------------------------------------------------------- #
    def start(self):
        """Serve from a daemon thread (the command-line worker calls
        ``serve_forever`` on its main thread instead)."""
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="bigdl-torch-replica-server", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self._server.serve_forever()

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(5)
