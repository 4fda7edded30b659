"""A sort server in a process of its own, and the load and scrape helpers
the drills drive it with (port of ``bench/serve_load.py``'s ``Server`` and
``run_load``, and of the scrape helpers of
``bench/chaos_serve_selftest.py``).

:class:`Server` spawns ``python -m mpitest_tpu_torch.sort_server`` (or a
caller's command, e.g. one that passes ``device="cpu"``) on ephemeral
ports with its own ``SORT_TRACE``; its stderr goes to a file, and its
startup wait is ``select()``-bounded, so a wedged server fails at the
deadline instead of hanging its caller.  The server's kernel launch
counts come from its ``/varz`` (``kernels.launches``), so a caller can
assert which kernels ran in the other process.
"""

from __future__ import annotations

import json
import os
import re
import select
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Callable

import numpy as np

from mpitest_tpu_torch.serve.client import ServeClient

HOST = "127.0.0.1"

#: The request mix of the reference's load generator: log-uniform
#: 2^LOG2_MIN..2^LOG2_MAX int32 keys, small enough to be packed.
LOG2_MIN, LOG2_MAX = 7, 10

#: The port's server driver.
DRIVER = (sys.executable, "-m", "mpitest_tpu_torch.sort_server")


class Server:
    """One spawned sort server (ephemeral ports, its own trace)."""

    #: Startup budget: the interpreter, torch, the kernel load and the
    #: prewarm.  The wait is select()-bounded.
    STARTUP_TIMEOUT_S = 180.0

    def __init__(self, out_dir: Path, tag: str, env_overrides: dict | None = None,
                 cmd: "tuple[str, ...] | list[str]" = DRIVER) -> None:
        out_dir.mkdir(parents=True, exist_ok=True)
        self.tag = tag
        self.trace = out_dir / f"server_trace_{tag}.jsonl"
        # stderr to a file, not a pipe: an undrained pipe could deadlock
        # the very startup the timeout bounds
        self.stderr_path = out_dir / f"server_{tag}.stderr.log"
        self._stderr_f = open(self.stderr_path, "w")
        env = dict(os.environ)
        env.update({"SORT_SERVE_PORT": "0", "SORT_METRICS_PORT": "0",
                    "SORT_TRACE": str(self.trace)})
        env.update(env_overrides or {})
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(list(cmd), stdout=subprocess.PIPE,
                                     stderr=self._stderr_f, text=True, env=env)
        self._stdout_buf = ""
        line = self._await_line()
        m = re.search(r"listening on [\d.]+:(\d+)", line)
        if not m:
            self.kill()
            raise RuntimeError(f"server ({tag}) did not come up: {line!r}\n"
                               f"{self.stderr_tail()}")
        self.port = int(m.group(1))
        self.metrics_port: int | None = None
        if env.get("SORT_METRICS_PORT") != "-1":
            mline = self._await_line()
            mm = re.search(r"metrics on [\d.]+:(\d+)", mline)
            if not mm:
                self.kill()
                raise RuntimeError(f"server ({tag}) printed no metrics line: "
                                   f"{mline!r}\n{self.stderr_tail()}")
            self.metrics_port = int(mm.group(1))
        #: seconds from the spawn to the sync lines
        self.start_s = time.perf_counter() - t0

    def _await_line(self) -> str:
        """One sync line, select() + os.read on the raw fd with our own
        buffer (two lines often arrive in one chunk)."""
        deadline = time.monotonic() + self.STARTUP_TIMEOUT_S
        assert self.proc.stdout is not None
        fd = self.proc.stdout.fileno()
        while time.monotonic() < deadline:
            if "\n" in self._stdout_buf:
                line, self._stdout_buf = self._stdout_buf.split("\n", 1)
                return line
            if self.proc.poll() is not None:
                return ""
            ready, _, _ = select.select([fd], [], [],
                                        min(1.0, max(0.0, deadline - time.monotonic())))
            if ready:
                chunk = os.read(fd, 1 << 16)
                if not chunk:
                    return ""
                self._stdout_buf += chunk.decode("utf-8", "replace")
        return ""

    def stderr_tail(self, nbytes: int = 2000) -> str:
        try:
            return self.stderr_path.read_text()[-nbytes:]
        except OSError:
            return "(no stderr captured)"

    # -- the side port ------------------------------------------------
    def get(self, route: str) -> tuple[int, str]:
        assert self.metrics_port is not None, "metrics port disabled"
        try:
            with urllib.request.urlopen(f"http://{HOST}:{self.metrics_port}{route}",
                                        timeout=30) as r:
                return r.status, r.read().decode("utf-8")
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode("utf-8")

    def get_json(self, route: str) -> tuple[int, dict]:
        code, text = self.get(route)
        return code, json.loads(text)

    def launches(self) -> dict[str, int]:
        """The server's kernel launch counts since it started."""
        return dict(self.get_json("/varz")[1]["kernels"]["launches"])

    # -- lifecycle ----------------------------------------------------
    def stop(self) -> int:
        """SIGTERM drain; the exit code (-9 if it had to be killed)."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)
            rc = -9
        self._close()
        return rc

    def kill(self) -> None:
        """SIGKILL: no drain, no atexit (the crash shape)."""
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)
        self._close()

    def _close(self) -> None:
        if self.proc.stdout is not None:
            self.proc.stdout.close()
        self._stderr_f.close()

    def spans(self) -> list[dict]:
        rows = []
        try:
            text = self.trace.read_text()
        except FileNotFoundError:
            return rows
        for ln in text.splitlines():
            try:
                rows.append(json.loads(ln))
            except json.JSONDecodeError:
                pass
        return rows


def launch_delta(before: dict[str, int], after: dict[str, int]) -> dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def mix_keys(rng: np.random.Generator) -> np.ndarray:
    """One request of the reference's mix."""
    n = int(2 ** rng.uniform(LOG2_MIN, LOG2_MAX))
    return rng.integers(-2**31, 2**31 - 1, size=n, dtype=np.int32)


def run_load(port: int, requests: int, clients: int, seed: int,
             trace_prefix: str | None = None) -> dict:
    """Closed-loop load: ``clients`` threads share ``requests`` requests
    of the mix, each reply checked against ``np.sort``.  Returns the ok
    latencies (sorted), the statuses, the replies that differed and the
    wall seconds."""
    lock = threading.Lock()
    lat: list[float] = []
    statuses: dict[str, int] = {}
    bad: list[str] = []
    claimed = [0]

    def worker(w: int) -> None:
        rng = np.random.default_rng(seed + w)
        with ServeClient(HOST, port, timeout=120) as c:
            while True:
                with lock:
                    if claimed[0] >= requests:
                        return
                    i = claimed[0]
                    claimed[0] += 1
                x = mix_keys(rng)
                tid = f"{trace_prefix}-{i}" if trace_prefix else None
                t0 = time.perf_counter()
                r = c.sort(x, trace_id=tid)
                dt = time.perf_counter() - t0
                with lock:
                    st = "ok" if r.ok else str(r.error)
                    statuses[st] = statuses.get(st, 0) + 1
                    if r.ok:
                        lat.append(dt)
                        if not np.array_equal(r.arr, np.sort(x)):
                            bad.append(str(r.trace_id))
                    if tid is not None and r.trace_id != tid:
                        bad.append(f"{tid}: echoed {r.trace_id!r}")

    threads = [threading.Thread(target=worker, args=(w,), name=f"load-{w}")
               for w in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"wall_s": time.perf_counter() - t0, "lat": sorted(lat),
            "statuses": statuses, "bad": bad}


def wait_until(pred: Callable[[], bool], timeout_s: float,
               interval: float = 0.1) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def metric_total(prom_text: str, name: str) -> float:
    """Sum of a family's own samples in a Prometheus text scrape."""
    from mpitest_tpu_torch.utils.metrics_live import parse_prom_text

    fam = parse_prom_text(prom_text).get(name)
    if not fam:
        return 0.0
    return float(sum(v for n, _l, v in fam["samples"] if n == name))
