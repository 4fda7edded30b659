"""Chaos TCP proxy: wire-level fault injection for the sort server (port
of the reference's ``bench/wire_chaos.py``, over the port's
``faults.parse_wire_faults``).

It sits between a well-behaved client and a real server and misbehaves
on purpose, per a wire-fault spec (``site[@param][:every]`` entries over
``faults.WIRE_SITES``):

* ``wire_torn_header@k``         -- forward only the first ``k`` request
  bytes, then close (a client that died mid-header).
* ``wire_stall_payload@k``       -- forward the header and ``k`` payload
  bytes, then go silent holding the connection open (the slow-loris: the
  server's read budget must shed it and reclaim its admission bytes).
* ``wire_disconnect_response@k`` -- forward the request, deliver ``k``
  response bytes, then close the client side.
* ``wire_slow_drip@ms``          -- drip the request upstream in small
  chunks with ``ms`` pauses: only a total read budget bounds it.
* ``wire_delay_response@ms``     -- hold the response back ``ms`` (the
  hedging cell's injected tail; ``:4`` stalls every 4th connection).
* ``wire_connect_silence``       -- accept the client, never connect
  upstream, never send a byte.

It knows one byte boundary of the protocol (the header's newline) and
keeps a per-connection decision ``log``.  Stdlib and the port's
``faults`` only.
"""

from __future__ import annotations

import socket
import threading
import time

from mpitest_tpu_torch.faults import WireFault, parse_wire_faults

#: Forwarding chunk size for the normal (unfaulted) relay path.
_CHUNK = 1 << 16

#: Drip chunk size for wire_slow_drip — small enough that a multi-KiB
#: payload takes many pauses.
_DRIP_CHUNK = 512


class ChaosProxy:
    """One listening socket relaying to ``(upstream_host,
    upstream_port)`` with wire faults applied per connection index.

    ``faults`` is a spec string or a parsed tuple; each connection
    applies the FIRST entry whose ``every`` matches its index (0-based
    arrival order), so ``"wire_delay_response@800:4"`` stalls exactly
    the 4th, 8th, ... connection and relays the rest cleanly."""

    def __init__(self, upstream_host: str, upstream_port: int,
                 faults: "str | tuple[WireFault, ...]" = (),
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.upstream = (upstream_host, upstream_port)
        self.faults: tuple[WireFault, ...] = (
            parse_wire_faults(faults) if isinstance(faults, str)
            else tuple(faults))
        self._listener = socket.create_server((host, port))
        self.port = self._listener.getsockname()[1]
        self._conn_seq = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._open: list[socket.socket] = []
        #: per-connection decisions: (index, fault-site or None)
        self.log: list[tuple[int, str | None]] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="chaos-accept", daemon=True)

    # -- lifecycle ----------------------------------------------------
    def start(self) -> "ChaosProxy":
        self._accept_thread.start()
        return self

    def __enter__(self) -> "ChaosProxy":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns, self._open = self._open, []
        for s in conns:
            try:
                s.close()
            except OSError:
                pass

    def _track(self, s: socket.socket) -> socket.socket:
        with self._lock:
            self._open.append(s)
        return s

    # -- accept / dispatch --------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _addr = self._listener.accept()
            except OSError:
                return
            with self._lock:
                idx = self._conn_seq
                self._conn_seq += 1
            fault = next((f for f in self.faults if f.fires_on(idx)),
                         None)
            self.log.append((idx, fault.site if fault else None))
            self._track(client)
            threading.Thread(target=self._serve_conn,
                             args=(client, fault),
                             name=f"chaos-conn-{idx}", daemon=True).start()

    def _serve_conn(self, client: socket.socket,
                    fault: WireFault | None) -> None:
        try:
            if fault is not None and fault.site == "wire_connect_silence":
                # hold the client open, say nothing, connect nowhere —
                # closed when the client gives up or the proxy stops
                self._stop.wait()
                return
            try:
                upstream = self._track(socket.create_connection(
                    self.upstream, timeout=10.0))
            except OSError:
                return
            t_up = threading.Thread(
                target=self._pipe_up, args=(client, upstream, fault),
                daemon=True)
            t_up.start()
            self._pipe_down(upstream, client, fault)
            t_up.join(timeout=1.0)
            try:
                upstream.close()
            except OSError:
                pass
        finally:
            try:
                client.close()
            except OSError:
                pass

    # -- client -> server ---------------------------------------------
    def _pipe_up(self, client: socket.socket, upstream: socket.socket,
                 fault: WireFault | None) -> None:
        """Relay request bytes, applying the request-side faults.  The
        header/payload boundary is the first newline — the only
        protocol knowledge the torn/stall sites need."""
        site = fault.site if fault else None
        param = fault.param if fault else 0
        sent = 0              # total request bytes forwarded
        header_done = False
        payload_sent = 0
        try:
            while True:
                try:
                    data = client.recv(_CHUNK)
                except OSError:
                    break
                if not data:
                    try:
                        upstream.shutdown(socket.SHUT_WR)
                    except OSError:
                        pass
                    break
                if site == "wire_torn_header":
                    budget = param - sent
                    if budget > 0:
                        upstream.sendall(data[:budget])
                        sent += min(len(data), budget)
                    if sent >= param:
                        # died mid-header: close BOTH directions
                        upstream.close()
                        client.close()
                        return
                    continue
                if site == "wire_stall_payload":
                    if not header_done:
                        nl = data.find(b"\n")
                        if nl < 0:
                            upstream.sendall(data)
                            sent += len(data)
                            continue
                        header_done = True
                        head, rest = data[:nl + 1], data[nl + 1:]
                        upstream.sendall(head)
                        sent += len(head)
                        data = rest
                        if not data:
                            continue
                    room = param - payload_sent
                    if room > 0:
                        upstream.sendall(data[:room])
                        payload_sent += min(len(data), room)
                        sent += min(len(data), room)
                    if payload_sent >= param:
                        # the slow-loris: k payload bytes delivered,
                        # then nothing, connection held open — the
                        # server's read budget must shed it
                        self._stop.wait()
                        return
                    continue
                if site == "wire_slow_drip":
                    for off in range(0, len(data), _DRIP_CHUNK):
                        if self._stop.is_set():
                            return
                        upstream.sendall(data[off:off + _DRIP_CHUNK])
                        time.sleep(param / 1e3)
                    sent += len(data)
                    continue
                upstream.sendall(data)
                sent += len(data)
        except OSError:
            pass

    # -- server -> client ---------------------------------------------
    def _pipe_down(self, upstream: socket.socket, client: socket.socket,
                   fault: WireFault | None) -> None:
        site = fault.site if fault else None
        param = fault.param if fault else 0
        delivered = 0
        delayed = False
        try:
            while True:
                try:
                    data = upstream.recv(_CHUNK)
                except OSError:
                    return
                if not data:
                    return
                if site == "wire_delay_response" and not delayed:
                    delayed = True
                    if self._stop.wait(param / 1e3):
                        return
                if site == "wire_disconnect_response":
                    room = param - delivered
                    if room > 0:
                        client.sendall(data[:room])
                        delivered += min(len(data), room)
                    if delivered >= param:
                        client.close()      # died mid-download
                        return
                    continue
                client.sendall(data)
                delivered += len(data)
        except OSError:
            return

