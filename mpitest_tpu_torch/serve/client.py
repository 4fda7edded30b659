"""Clients for the sort server's ``sortserve.v1`` wire protocol (port of
``mpitest_tpu/serve/client.py``; the bytes on the wire are the
reference's, so either package's client talks to either package's
server).

* :class:`ServeClient` — one TCP connection, the raw protocol.  May
  issue many requests back to back; a typed error response comes back as
  a :class:`ServeReply` with ``ok=False`` and the server's stable
  ``error`` code — it never raises on a server-side rejection, only on
  transport failure.  Connect and read timeouts bound every wire wait.
* :class:`ResilientClient` — bounded retry with exponential backoff +
  jitter on connect errors and typed-retryable responses
  (``backpressure``, ``draining``), plus optional request **hedging**:
  when a reply has not landed within ``hedge_after_s``, a second attempt
  races it on a fresh connection and the first reply that passes the
  client-side fingerprint check wins (sort is idempotent, so the loser
  is simply discarded).

This module imports nothing of the server stack (torch, the models
layer): load generators and remote clients need only the wire protocol.
"""

from __future__ import annotations

import json
import os
import queue
import random
import socket
import threading
import time
from dataclasses import dataclass

import numpy as np

#: Must match serve/server.py (kept literal here so the client is
#: importable without the server stack).
WIRE_SCHEMA = "sortserve.v1"

#: Typed error codes the server emits when it WANTS the client to come
#: back later — the retry allowlist.  Anything else (bad_request,
#: integrity, ...) retries would only repeat.
RETRYABLE_ERRORS = ("backpressure", "draining")


@dataclass
class ServeReply:
    """One response: ``ok`` + sorted ``arr``, or a typed error."""

    ok: bool
    header: dict
    arr: np.ndarray | None = None
    #: record requests: the payload permuted into key order,
    #: an ``(n, payload_bytes)`` uint8 matrix.
    payload: np.ndarray | None = None

    @property
    def error(self) -> str | None:
        return None if self.ok else str(self.header.get("error"))

    @property
    def spilled(self) -> bool:
        """True when the server served this request from the
        out-of-core spill tier."""
        return bool(self.header.get("spilled"))

    @property
    def detail(self) -> str:
        return str(self.header.get("detail", ""))

    @property
    def trace_id(self) -> str | None:
        """The request's end-to-end trace id, echoed by the server
        — the key ``report.py --trace-id`` reconstructs the
        request from."""
        v = self.header.get("trace_id")
        return str(v) if v is not None else None

    @property
    def plan(self) -> dict | None:
        """Compact decision digest of the dispatch that served this
        request: algo, negotiated cap, restage verdict,
        regret — the client-visible decision-drift signal."""
        v = self.header.get("plan")
        return v if isinstance(v, dict) else None


class ServeClient:
    """One persistent connection to a sort server.  ``timeout`` bounds
    every read/write on the socket; ``connect_timeout`` (default: the
    read timeout) bounds the initial connect."""

    def __init__(self, host: str, port: int, timeout: float = 120.0,
                 connect_timeout: float | None = None) -> None:
        self.sock = socket.create_connection(
            (host, port),
            timeout=timeout if connect_timeout is None else connect_timeout)
        self.sock.settimeout(timeout)
        self._rfile = self.sock.makefile("rb")

    def close(self) -> None:
        try:
            self._rfile.close()
        finally:
            self.sock.close()

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()

    def sort(self, arr: np.ndarray, algo: str | None = None,
             faults: str | None = None,
             trace_id: str | None = None,
             deadline_ms: float | None = None,
             payload: np.ndarray | bytes | None = None,
             dataset_id: str | None = None) -> ServeReply:
        """Send one sort request; block for the reply.  A ``trace_id``
        is minted here when the caller supplies none — the client IS
        the wire layer, so every request carries one end to end (the
        server echoes it in the response header).  ``deadline_ms``
        rides the header: the server cancels the request
        typed ``deadline_exceeded`` if the budget expires before
        dispatch.  ``payload`` turns the request into a
        record sort: bytes (``n * width``) or an ``(n, width)`` uint8
        matrix of per-record payloads, returned permuted into key
        order on ``reply.payload``.  ``dataset_id`` is a
        stable client-chosen id keying the spill tier's journaled
        manifest: a retried over-memory request reusing it resumes at
        the merge phase (``resumed: true`` in the reply plan digest)."""
        arr = np.ascontiguousarray(arr).reshape(-1)
        n = int(arr.size)
        hdr: dict = {"v": WIRE_SCHEMA, "dtype": arr.dtype.name,
                     "n": n,
                     "trace_id": trace_id or os.urandom(8).hex()}
        pay_bytes = b""
        if payload is not None:
            if isinstance(payload, (bytes, bytearray, memoryview)):
                pay_bytes = bytes(payload)
            else:
                # raw little-endian BYTES of the array — the same
                # canonical form as the library's as_payload_matrix (a
                # uint64 row-id array is a valid 8-byte payload as-is).
                # A value-cast to uint8 here would silently truncate
                # every payload element above 255.
                pay_bytes = np.ascontiguousarray(
                    np.asarray(payload)).tobytes()
            if n == 0 or len(pay_bytes) % n:
                raise ValueError(
                    f"payload of {len(pay_bytes)} bytes is not a "
                    f"multiple of the key count {n}")
            hdr["payload_bytes"] = len(pay_bytes) // n
        if algo is not None:
            hdr["algo"] = algo
        if faults is not None:
            hdr["faults"] = faults
        if deadline_ms is not None:
            hdr["deadline_ms"] = float(deadline_ms)
        if dataset_id is not None:
            hdr["dataset_id"] = dataset_id
        self.sock.sendall(json.dumps(hdr).encode("utf-8") + b"\n"
                          + arr.tobytes() + pay_bytes)
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("server closed the connection "
                                  "without a response header")
        resp = json.loads(line.decode("utf-8"))
        if not resp.get("ok"):
            return ServeReply(False, resp)
        rn = int(resp["n"])
        dt = np.dtype(str(resp["dtype"]))
        width = int(resp.get("payload_bytes", 0) or 0)
        nbytes = rn * (dt.itemsize + width)
        blob = self._rfile.read(nbytes)
        if len(blob) != nbytes:
            raise ConnectionError(
                f"short response payload ({len(blob)}/{nbytes})")
        out = np.frombuffer(blob[:rn * dt.itemsize], dtype=dt).copy()
        out_pay = None
        if width:
            out_pay = np.frombuffer(
                blob[rn * dt.itemsize:], np.uint8).reshape(rn,
                                                           width).copy()
        return ServeReply(True, resp, out, out_pay)


def reply_fingerprint_ok(request: np.ndarray,
                         reply: ServeReply) -> bool:
    """Client-side verification a hedged reply must pass before it
    wins: same element count, non-decreasing order, and —
    for integer keys — the XOR multiset fold of the reply equal to the
    request's (one O(n) pass; a reply carrying someone else's bytes or
    a truncation cannot pass all three).  Floats skip the XOR leg
    (NaN-safe bit games are the server verifier's job) but keep the
    count/order checks."""
    if not reply.ok or reply.arr is None:
        return False
    out = reply.arr
    if out.size != request.size or out.dtype != request.dtype:
        return False
    if out.size == 0:
        return True
    if out.dtype.kind in "iu":
        if not bool(np.all(out[:-1] <= out[1:])):
            return False
        width = f"uint{out.dtype.itemsize * 8}"
        fold_req = np.bitwise_xor.reduce(request.view(width))
        fold_out = np.bitwise_xor.reduce(out.view(width))
        return bool(fold_req == fold_out)
    # floats: total-order sortedness modulo NaNs is the server's
    # verifier domain; check what is cheap and unambiguous here
    finite = out[~np.isnan(out)]
    return bool(np.all(finite[:-1] <= finite[1:])) if finite.size else True


class ResilientClient:
    """Retrying, optionally hedging client.  Each attempt
    uses a FRESH connection — a retry must never reuse the socket whose
    peer just stalled, and hedged attempts must not share a stream.

    ``stats`` counts attempts/retries/hedges/hedge_wins; pass
    ``spanlog`` (any object with a ``record(name, t0, dt, **attrs)``
    method — e.g. ``utils.spans.SpanLog``) to record registered
    ``serve.hedge`` events, and ``metrics`` (a
    ``utils.metrics_live.LiveMetrics``) to feed
    ``sort_client_hedges_total``."""

    def __init__(self, host: str, port: int, *,
                 connect_timeout: float = 5.0,
                 read_timeout: float = 120.0,
                 max_attempts: int = 4,
                 backoff_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 jitter: float = 0.5,
                 hedge_after_s: float | None = None,
                 seed: int = 0,
                 spanlog: object | None = None,
                 metrics: object | None = None) -> None:
        self.host = host
        self.port = port
        self.connect_timeout = float(connect_timeout)
        self.read_timeout = float(read_timeout)
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.jitter = float(jitter)
        self.hedge_after_s = hedge_after_s
        self.spanlog = spanlog
        self.metrics = metrics
        self._rng = random.Random(seed)
        #: counters are bumped from the primary AND hedge threads —
        #: a bare += would lose increments under the race
        self._stats_lock = threading.Lock()
        self.stats = {"attempts": 0, "retries": 0, "hedges": 0,
                      "hedge_wins": 0, "transport_errors": 0}

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    # -- one wire attempt --------------------------------------------
    def _one(self, arr: np.ndarray, algo: str | None,
             trace_id: str | None,
             deadline_ms: float | None) -> ServeReply:
        self._bump("attempts")
        with ServeClient(self.host, self.port,
                         timeout=self.read_timeout,
                         connect_timeout=self.connect_timeout) as c:
            return c.sort(arr, algo=algo, trace_id=trace_id,
                          deadline_ms=deadline_ms)

    def _hedged(self, arr: np.ndarray, algo: str | None,
                trace_id: str | None,
                deadline_ms: float | None) -> ServeReply:
        """Primary attempt; if no reply within ``hedge_after_s``, race
        a second attempt on a fresh connection.  First reply passing
        the fingerprint check wins; the loser is discarded (its daemon
        thread dies on its own closed/answered socket).  Once the
        hedge is in flight the wait BLOCKS until an attempt resolves —
        each attempt is already self-bounded by its connect/per-recv
        socket timeouts, exactly like the non-hedged path, so an
        extra wall budget here would only abandon a legitimate
        long transfer mid-flight."""
        assert self.hedge_after_s is not None
        results: "queue.Queue[tuple[str, ServeReply | None, Exception | None]]" = queue.Queue()

        def attempt(tag: str, tid: str | None) -> None:
            try:
                results.put((tag, self._one(arr, algo, tid, deadline_ms),
                             None))
            except (OSError, ConnectionError,
                    json.JSONDecodeError) as e:
                results.put((tag, None, e))

        t0 = time.perf_counter()
        threading.Thread(target=attempt, args=("primary", trace_id),
                         daemon=True).start()
        hedged = False
        outcomes: list[tuple[str, ServeReply | None, Exception | None]] = []
        expected = 1
        while len(outcomes) < expected:
            try:
                if hedged:
                    outcomes.append(results.get())
                else:
                    outcomes.append(results.get(
                        timeout=self.hedge_after_s))
            except queue.Empty:
                # the tail: fire the hedge
                hedged = True
                expected = 2
                self._bump("hedges")
                if self.metrics is not None:
                    self.metrics.counter(
                        "sort_client_hedges_total").inc(1)
                # the "-h" suffix must stay inside the server's 64-char
                # trace-id grammar; a near-limit caller id gets a fresh
                # mint instead (ServeClient mints when None)
                hedge_tid = (f"{trace_id}-h"
                             if trace_id and len(trace_id) <= 62
                             else None)
                threading.Thread(target=attempt,
                                 args=("hedge", hedge_tid),
                                 daemon=True).start()
                continue
            tag, reply, exc = outcomes[-1]
            if reply is not None and reply_fingerprint_ok(arr, reply):
                if hedged:
                    if tag == "hedge":
                        self._bump("hedge_wins")
                    if self.spanlog is not None:
                        self.spanlog.record(
                            "serve.hedge", t0, time.perf_counter() - t0,
                            winner=tag,
                            waited_ms=round(self.hedge_after_s * 1e3, 3))
                return reply
        # every attempt resolved without a verified success: surface
        # the most informative outcome — a typed server reply beats a
        # transport exception
        for _tag, reply, _exc in outcomes:
            if reply is not None:
                return reply
        for _tag, _reply, exc in outcomes:
            if exc is not None:
                raise exc
        raise ConnectionError("hedged request: no attempt produced a "
                              "reply")

    # -- the public entry --------------------------------------------
    def sort(self, arr: np.ndarray, algo: str | None = None,
             trace_id: str | None = None,
             deadline_ms: float | None = None) -> ServeReply:
        """Sort with bounded retry (+ optional hedging).  Returns the
        first verified-ok or non-retryable typed reply; raises
        ``ConnectionError`` only when every attempt failed at the
        transport level.  ``deadline_ms`` is the caller's END-TO-END
        budget: each attempt sends only the budget still REMAINING
        (elapsed backoff and failed attempts shrink it — a retry must
        never hand the server a fresh full deadline), and once it is
        exhausted the client fails locally with a typed
        ``deadline_exceeded`` reply instead of attempting at all."""
        arr = np.ascontiguousarray(arr).reshape(-1)
        t_start = time.monotonic()
        last_exc: Exception | None = None
        last_reply: ServeReply | None = None
        for attempt in range(self.max_attempts):
            if attempt:
                self._bump("retries")
                delay = min(self.backoff_s * (2 ** (attempt - 1)),
                            self.backoff_cap_s)
                # full jitter fraction: desynchronizes a thundering
                # herd of clients all told to back off at once
                delay *= 1.0 + self.jitter * self._rng.random()
                time.sleep(delay)
            remaining_ms: float | None = None
            if deadline_ms is not None:
                remaining_ms = deadline_ms - (time.monotonic()
                                              - t_start) * 1e3
                if remaining_ms <= 0:
                    return ServeReply(False, {
                        "ok": False, "error": "deadline_exceeded",
                        "detail": f"client-side: {deadline_ms:g} ms "
                                  f"budget exhausted after {attempt} "
                                  "attempt(s)",
                        "trace_id": trace_id})
            try:
                if self.hedge_after_s is not None:
                    reply = self._hedged(arr, algo, trace_id,
                                         remaining_ms)
                else:
                    reply = self._one(arr, algo, trace_id, remaining_ms)
            except (OSError, ConnectionError, json.JSONDecodeError) as e:
                # JSONDecodeError: a truncated/garbled response header
                # (connection died mid-reply) is a transport fault like
                # any other — retry, never escape the documented
                # ConnectionError-only contract
                self._bump("transport_errors")
                last_exc = e
                continue
            if reply.ok and not reply_fingerprint_ok(arr, reply):
                # a reply that fails the client-side fold is treated
                # like a transport fault: never returned as success
                last_exc = ConnectionError(
                    "reply failed the client-side fingerprint check")
                continue
            if not reply.ok and reply.error in RETRYABLE_ERRORS:
                last_reply = reply
                continue
            return reply
        if last_reply is not None:
            return last_reply       # typed + retryable, budget spent
        raise ConnectionError(
            f"sort failed after {self.max_attempts} attempt(s): "
            f"{last_exc}")


def sort_once(host: str, port: int, arr: np.ndarray,
              algo: str | None = None, faults: str | None = None,
              timeout: float = 120.0) -> ServeReply:
    """One-shot convenience: connect, sort, close."""
    with ServeClient(host, port, timeout=timeout) as c:
        return c.sort(arr, algo=algo, faults=faults)
