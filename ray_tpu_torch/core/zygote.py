"""Worker zygote: fork-server that spawns workers from a warm template.

Starting a worker as a fresh interpreter pays the full import chain every
time (python startup + ray_tpu_torch.core.worker + numpy + torch).  The reference
amortizes this with WorkerPool prestart (worker_pool.h:159 keeps idle
workers around before they are needed); a zygote goes further: ONE
template process per (head | node manager) imports everything once, then
every subsequent worker is an os.fork() of that warm image — milliseconds
instead of seconds, which is what makes thousand-actor populations and
worker-churn tests cheap on small hosts.

Safety model: the zygote binds its unix socket, imports the worker stack,
and only then serves requests from a SINGLE-THREADED loop — at fork time
no other thread can hold a lock in the child.  torch is imported (its
import spawns no Python thread; the package's own __init__ imports it)
but CUDA is never initialized in the template: a child forked from a
process with a CUDA context fails with "Cannot re-initialize CUDA in
forked subprocess".  The template is a CPU-class process
(CUDA_VISIBLE_DEVICES="", node_manager.cpu_worker_env), so only
CPU-class workers fork from it.

Workers whose spawn genuinely needs a fresh exec — container runtime
envs (chroot wrapper) and GPU-visible workers — keep the
subprocess.Popen path in node_manager.spawn_worker_process.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, Optional

_LEN = struct.Struct("<I")


def _send_msg(sock: socket.socket, obj) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(_LEN.pack(len(data)) + data)


class _Desync(OSError):
    """Partial frame (EOF or timeout mid-message): the stream position is
    unknowable — the connection must be dropped, never re-read."""


def _recv_msg(sock: socket.socket):
    """Read one frame.  None = clean EOF between frames; socket.timeout
    between frames propagates (idle); a timeout or EOF MID-frame raises
    _Desync so callers close instead of parsing from a torn position."""
    hdr = _recv_exact(sock, _LEN.size, started=False)
    if hdr is None:
        return None
    (n,) = _LEN.unpack(hdr)
    body = _recv_exact(sock, n, started=True)
    return json.loads(body)


def _recv_exact(sock: socket.socket, n: int, *,
                started: bool) -> Optional[bytes]:
    """started=False: clean EOF returns None, zero-byte timeout
    propagates socket.timeout (idle).  Any partial read ending in EOF or
    timeout raises _Desync."""
    buf = b""
    while len(buf) < n:
        try:
            part = sock.recv(n - len(buf))
        except socket.timeout:
            if buf or started:
                raise _Desync("timeout mid-frame")
            raise
        if not part:
            if buf or started:
                raise _Desync("EOF mid-frame")
            return None
        buf += part
    return buf


# ---------------------------------------------------------------------------
# Server side (the template process)
# ---------------------------------------------------------------------------


class _ZygoteServer:
    def __init__(self, sock_path: str):
        self.sock_path = sock_path
        self.listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            os.unlink(sock_path)
        except FileNotFoundError:
            pass
        self.listener.bind(sock_path)
        self.listener.listen(4)
        self.children: Dict[int, str] = {}  # pid -> spawn nonce ("" if none)
        self.exited: Dict[int, int] = {}  # pid -> exit code (drained by poll)
        self.parent_pid = os.getppid()
        self._torch_warmed = False
        self._fork_unsafe = False

    def warm(self) -> None:
        """Import the worker stack (fast — a few hundred ms).  Runs after
        bind/listen so the owner's connect() never races it.  The heavier
        torch import stays DEFERRED to idle loop ticks (_warm_torch): at
        cluster boot every template (head + each node manager) would
        otherwise burn seconds of CPU importing torch concurrently with
        worker spawns — on small hosts that starves remote nodes of
        their first workers and measurably skews scheduling.  A
        spawn/poll colliding with the deferred import times out
        client-side and falls back to Popen; the owner's stale-nonce
        reap cleans up if the buffered spawn executes later, and the
        prewarm ping's long reconnect timeout (ZygoteHandle._ensure)
        keeps those collisions from counting toward the disable
        threshold."""
        import ray_tpu_torch.core.worker  # noqa: F401  (the whole point)

        try:
            import numpy  # noqa: F401
        except Exception:
            pass
        self._check_fork_safe()

    def _check_fork_safe(self) -> None:
        if threading.active_count() > 1:
            # A pre-imported module started a thread: forking now could
            # inherit a lock held by it.  Refuse spawns; the owner falls
            # back to Popen spawns.
            print("zygote: import started extra threads "
                  f"({[t.name for t in threading.enumerate()]})",
                  file=sys.stderr, flush=True)
            self._fork_unsafe = True

    def _warm_torch(self) -> None:
        """Import torch on an idle tick — import only: nothing here may
        call into torch.cuda, since a template that initialized CUDA
        would fork children that cannot use it.  (The port's package
        __init__ imports torch, so warm() has usually brought it in.)"""
        self._torch_warmed = True
        try:
            import torch  # noqa: F401
        except Exception:
            pass
        self._check_fork_safe()

    def serve_forever(self) -> None:
        self.listener.settimeout(0.5)
        conn = None
        while True:
            self._reap()
            if os.getppid() != self.parent_pid:
                break  # owner died; workers are independent sessions
            if conn is None:
                try:
                    conn, _ = self.listener.accept()
                except socket.timeout:
                    if not self._torch_warmed:
                        self._warm_torch()
                    continue
                conn.settimeout(0.5)
            try:
                req = _recv_msg(conn)
            except socket.timeout:
                if not self._torch_warmed:
                    self._warm_torch()
                continue
            except OSError:
                req = None
            if req is None:
                conn.close()
                conn = None  # owner reconnect allowed
                continue
            try:
                reply = self._handle(req, conn)
            except SystemExit:
                raise
            except Exception as e:  # noqa: BLE001 — report, keep serving
                reply = {"error": f"{type(e).__name__}: {e}"}
            if reply is not None:
                try:
                    _send_msg(conn, reply)
                except OSError:
                    # The owner closed this connection (e.g. a client-side
                    # timeout while this request sat in the socket buffer).
                    # If the request we just served was a spawn, the owner
                    # never learned the pid and has already fallen back to
                    # a Popen spawn under the SAME worker id — kill the
                    # orphan fork before two processes register as one
                    # worker.
                    if req.get("op") == "spawn" and "pid" in reply:
                        try:
                            os.kill(reply["pid"], signal.SIGKILL)
                        except (ProcessLookupError, PermissionError):
                            pass
                        self.children.pop(reply["pid"], None)
                    conn.close()
                    conn = None

    def _reap(self) -> None:
        while True:
            try:
                pid, status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                return
            if pid == 0:
                return
            self.children.pop(pid, None)
            self.exited[pid] = (os.waitstatus_to_exitcode(status)
                                if hasattr(os, "waitstatus_to_exitcode")
                                else status)
            if len(self.exited) > 8192:  # bound the history
                for old in list(self.exited)[:4096]:
                    del self.exited[old]

    def _handle(self, req: dict, conn: socket.socket):
        op = req.get("op")
        if op == "spawn":
            if self._fork_unsafe:
                return {"error": "template has extra threads; fork unsafe"}
            pid = os.fork()
            if pid == 0:
                self._child(req, conn)  # never returns
            self.children[pid] = req.get("nonce", "")
            # The kernel may hand a new fork a previously-recorded pid;
            # a stale exit record would make the owner declare the new
            # worker dead on its first poll.
            self.exited.pop(pid, None)
            return {"pid": pid, "nonce": req.get("nonce", "")}
        if op == "poll_all":
            self._reap()
            out = {"alive": list(self.children), "exited": self.exited}
            self.exited = {}
            return out
        if op == "kill":
            try:
                os.kill(req["pid"], req.get("sig", signal.SIGKILL))
                return {"ok": True}
            except ProcessLookupError:
                return {"ok": False}
        if op == "reap_stale":
            # The owner timed out waiting for these spawns' replies and
            # fell back to Popen: if any of them executed anyway, the fork
            # is a ghost worker sharing the fallback's worker id — kill it.
            stale = set(req.get("nonces", ()))
            killed = []
            for pid, nonce in list(self.children.items()):
                if nonce and nonce in stale:
                    try:
                        os.kill(pid, signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        pass
                    self.children.pop(pid, None)
                    killed.append(pid)
            return {"ok": True, "killed": killed}
        if op == "ping":
            return {"ok": True, "pid": os.getpid()}
        if op == "shutdown":
            for pid in list(self.children):
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            try:
                _send_msg(conn, {"ok": True})
            except OSError:
                pass
            raise SystemExit(0)
        return {"error": f"unknown op {op!r}"}

    def _child(self, req: dict, conn: socket.socket) -> None:
        """Forked child: become the worker process."""
        try:
            os.setsid()
            self.listener.close()
            conn.close()
            log_base = req["log_base"]
            out = open(log_base + ".out", "ab", buffering=0)
            err = open(log_base + ".err", "ab", buffering=0)
            os.dup2(out.fileno(), 1)
            os.dup2(err.fileno(), 2)
            for s in (signal.SIGTERM, signal.SIGINT, signal.SIGCHLD):
                signal.signal(s, signal.SIG_DFL)
            try:  # name the fork for ps/top (cmdline still reads zygote)
                import ctypes

                libc = ctypes.CDLL(None, use_errno=True)
                libc.prctl(15, b"rt-worker", 0, 0, 0)  # PR_SET_NAME
            except Exception:
                pass
            env = req["env"]
            os.environ.clear()
            os.environ.update(env)
            # PYTHONPATH is normally consumed at interpreter start; a
            # forked worker applies additions (runtime-env py_modules /
            # user paths) by hand.
            for p in reversed(env.get("PYTHONPATH", "").split(os.pathsep)):
                if p and p not in sys.path:
                    sys.path.insert(0, p)
            cwd = req.get("cwd")
            if cwd:
                try:
                    os.chdir(cwd)
                except OSError:
                    pass
            import random

            random.seed()  # forked children must not share RNG streams
            try:
                import numpy as _np

                _np.random.seed()
            except Exception:
                pass
            from ray_tpu_torch.core.config import reset_config

            reset_config()  # env differs from the template's
            from ray_tpu_torch.core import worker

            worker.main()
            os._exit(0)
        except SystemExit as e:
            os._exit(int(e.code or 0))
        except BaseException:  # noqa: BLE001 — last-resort child report
            import traceback

            traceback.print_exc()
            os._exit(1)


def main() -> None:
    sock_path = None
    args = sys.argv[1:]
    for i, a in enumerate(args):
        if a == "--socket":
            sock_path = args[i + 1]
    if not sock_path:
        print("usage: zygote --socket PATH", file=sys.stderr)
        raise SystemExit(2)
    srv = _ZygoteServer(sock_path)
    srv.warm()
    try:
        srv.serve_forever()
    finally:
        try:
            os.unlink(sock_path)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Owner side (head process / node manager daemon)
# ---------------------------------------------------------------------------


class ZygoteProc:
    """Popen-alike for a zygote-forked worker (pid/poll/terminate/kill)."""

    __slots__ = ("pid", "returncode", "_handle")

    def __init__(self, handle: "ZygoteHandle", pid: int):
        self._handle = handle
        self.pid = pid
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.returncode is None:
            try:  # reaped-and-gone is detectable without any template IPC
                os.kill(self.pid, 0)
            except ProcessLookupError:
                self.returncode = self._handle.exit_code(self.pid)
                return self.returncode
            except PermissionError:
                pass
            self.returncode = self._handle.status(self.pid)
        return self.returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.time() + timeout
        while self.poll() is None:
            if deadline is not None and time.time() > deadline:
                raise subprocess.TimeoutExpired("zygote-worker", timeout)
            time.sleep(0.05)
        return self.returncode  # type: ignore[return-value]

    def terminate(self) -> None:
        self._handle.kill(self.pid, signal.SIGTERM)

    def kill(self) -> None:
        self._handle.kill(self.pid, signal.SIGKILL)

    def __repr__(self) -> str:
        return f"<ZygoteProc pid={self.pid} returncode={self.returncode}>"


class ZygoteHandle:
    """Lazily starts and talks to this process's zygote template."""

    _POLL_CACHE_S = 0.3

    def __init__(self):
        self._lock = threading.Lock()
        self._proc: Optional[subprocess.Popen] = None
        self._conn: Optional[socket.socket] = None
        self._sock_path: Optional[str] = None
        self._alive: set = set()
        self._exited: Dict[int, int] = {}
        self._polled_at = 0.0
        self._broken = False
        # Until the template answers a ping, spawn() raises and callers
        # use the Popen path — a cold/contended template must never add
        # latency to a worker the scheduler is already waiting on.
        self._ready = False
        self._warming = False
        self._failures = 0
        self._disabled = False
        # Nonces of spawn requests whose reply we never saw (client-side
        # timeout): the template may still execute them later, forking a
        # ghost worker under a worker id we have already re-used for a
        # Popen fallback.  Flushed as a reap_stale op before the next
        # request so such forks are detected and killed.  Ordered so the
        # overflow bound evicts the OLDEST nonce, never a pending one.
        self._stale_nonces: Dict[str, None] = {}

    def prewarm(self) -> None:
        """Kick off template start + connect on a daemon thread (idempotent,
        never blocks).  Call at head/node-manager startup so warmup hides
        inside cluster boot."""
        with self._lock:
            if self._ready or self._warming or self._disabled:
                return
            self._warming = True

        def _bg():
            # The template's deferred torch import (_warm_torch) can block
            # its serve loop for seconds; a ping colliding with it times
            # out at the normal 5 s.  That is the WARMUP WINDOW, not a
            # broken template: retry with short attempts (each holds
            # self._lock for at most the 5 s socket timeout, so
            # foreground spawn/status callers stay fail-fast) until a
            # deadline, and only count a disable strike when the whole
            # window expires.
            deadline = time.time() + 120.0
            try:
                while True:
                    try:
                        self._request({"op": "ping"}, start=True)
                        self._ready = True
                        self._failures = 0
                        return
                    except Exception:
                        if time.time() >= deadline:
                            self._failures += 1
                            if self._failures >= 3:
                                # Broken environment: stay on Popen.
                                self._disabled = True
                            return
                        time.sleep(1.0)
            finally:
                self._warming = False

        threading.Thread(target=_bg, daemon=True,
                         name="zygote-warmup").start()

    # -- lifecycle ---------------------------------------------------------

    def _ensure(self, start: bool) -> None:
        """Lock held.  Connect (and with start=True, launch) the template.

        Only prewarm's background thread passes start=True: every
        foreground caller — spawn under the head's scheduler lock,
        poll/kill under sweep locks — must never pay template startup
        (up to 120 s of warm imports); they fail fast and fall back."""
        alive = self._proc is not None and self._proc.poll() is None
        if self._conn is not None and alive and not self._broken:
            return
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None
        if alive and self._sock_path:
            # Template still running, only the socket hiccuped: the
            # server loops back to accept(), so reconnect instead of
            # abandoning the warm template for the session.
            try:
                conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                conn.settimeout(5.0)  # template is warm already
                conn.connect(self._sock_path)
                self._conn = conn
                self._broken = False
                return
            except OSError:
                try:
                    self._proc.kill()
                except OSError:
                    pass
                self._proc = None
        if not start:
            self._ready = False  # route spawns to Popen; prewarm restarts
            raise RuntimeError("zygote template not running")
        from ray_tpu_torch.core.node_manager import cpu_worker_env

        self._sock_path = os.path.join(
            tempfile.gettempdir(), f"rtz-{os.getpid()}-{os.urandom(4).hex()}")
        env = cpu_worker_env(dict(os.environ))
        log = open(os.path.join(tempfile.gettempdir(),
                                f"rtz-{os.getpid()}.log"), "ab")
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.zygote",
             "--socket", self._sock_path],
            env=env, stdin=subprocess.DEVNULL, stdout=log, stderr=log)
        deadline = time.time() + 30.0
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        while True:
            try:
                conn.connect(self._sock_path)
                break
            except OSError:
                if time.time() > deadline or self._proc.poll() is not None:
                    raise RuntimeError("zygote failed to start")
                time.sleep(0.05)
        conn.settimeout(120.0)  # first request waits on warm imports
        self._conn = conn
        self._alive = set()
        self._exited = {}
        self._polled_at = 0.0

    def _request(self, req: dict, *, start: bool = False) -> dict:
        with self._lock:
            self._ensure(start)
            try:
                if self._stale_nonces and req.get("op") != "reap_stale":
                    # Same-connection ordering guarantees the reap runs
                    # after any still-buffered stale spawn it names.
                    _send_msg(self._conn, {"op": "reap_stale",
                                           "nonces": list(self._stale_nonces)})
                    r = _recv_msg(self._conn)
                    if r is not None and "error" not in r:
                        self._stale_nonces.clear()
                _send_msg(self._conn, req)
                reply = _recv_msg(self._conn)
            except OSError as e:
                self._broken = True
                raise RuntimeError(f"zygote connection lost: {e}")
            if reply is None:
                self._broken = True
                raise RuntimeError("zygote closed the connection")
            if "error" in reply:
                raise RuntimeError(f"zygote: {reply['error']}")
            self._broken = False
            if self._conn.gettimeout() != 5.0:
                # Only the FIRST request may wait on warm imports; after
                # that, callers (some under the head's global lock, e.g.
                # worker sweeps doing proc.poll()) must never block long
                # on a wedged template.
                self._conn.settimeout(5.0)
            return reply

    # -- operations --------------------------------------------------------

    def spawn(self, *, env: dict, log_base: str, cwd: str) -> ZygoteProc:
        if not self._ready:
            self.prewarm()
            raise RuntimeError("zygote template not ready yet")
        nonce = os.urandom(8).hex()
        try:
            reply = self._request(
                {"op": "spawn", "env": env, "log_base": log_base,
                 "cwd": cwd, "nonce": nonce})
        except RuntimeError:
            # Template died/hiccuped: stop routing spawns here (callers
            # fall back to Popen) and re-warm in the background.  The
            # request may still execute out of the socket buffer later —
            # remember the nonce so the fork gets reaped, not adopted.
            with self._lock:
                self._stale_nonces[nonce] = None
                while len(self._stale_nonces) > 1024:
                    self._stale_nonces.pop(next(iter(self._stale_nonces)))
            self._ready = False
            self.prewarm()
            raise
        pid = reply["pid"]
        with self._lock:
            self._alive.add(pid)
            self._exited.pop(pid, None)  # pid reuse: drop stale exit record
        return ZygoteProc(self, pid)

    def exit_code(self, pid: int) -> int:
        """Recorded exit code for a pid known to be gone (-1 if the
        template never reported one, e.g. it died before reaping)."""
        with self._lock:
            return self._exited.get(pid, -1)

    def status(self, pid: int) -> Optional[int]:
        """Exit code if the worker has exited, else None (= running).
        A transient template hiccup must NOT read as worker death — the
        caller (ZygoteProc.poll) has already os.kill(pid, 0)-checked
        that the process exists, so on template trouble we report
        'running' and let the next poll retry."""
        now = time.time()
        with self._lock:
            if pid in self._exited:
                return self._exited[pid]
            if now - self._polled_at < self._POLL_CACHE_S \
                    and pid in self._alive:
                return None
        try:
            reply = self._request({"op": "poll_all"})
        except RuntimeError:
            return None  # process exists (caller checked); template flaky
        with self._lock:
            self._alive = set(reply["alive"])
            for p, code in reply["exited"].items():
                self._exited[int(p)] = code
            if len(self._exited) > 8192:
                for old in list(self._exited)[:4096]:
                    del self._exited[old]
            self._polled_at = now
            if pid in self._exited:
                return self._exited[pid]
            # Not this template's child (restarted template) but the
            # process exists per the caller's os.kill check: running.
            return None

    def kill(self, pid: int, sig: int) -> None:
        # Direct signal: pids are host pids and several callers hold
        # control-plane locks expecting Popen's non-blocking kill() —
        # the template only REAPS (its waitpid loop collects the exit).
        try:
            os.kill(pid, sig)
        except ProcessLookupError:
            pass

    def shutdown(self) -> None:
        with self._lock:
            if self._conn is None:
                return
            try:
                _send_msg(self._conn, {"op": "shutdown"})
                self._conn.settimeout(5.0)
                _recv_msg(self._conn)
            except OSError:
                pass
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None
            if self._proc is not None:
                try:
                    self._proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    self._proc.kill()
                self._proc = None


_HANDLE: Optional[ZygoteHandle] = None
_HANDLE_LOCK = threading.Lock()


def get_zygote() -> ZygoteHandle:
    global _HANDLE
    with _HANDLE_LOCK:
        if _HANDLE is None:
            _HANDLE = ZygoteHandle()
            import atexit

            atexit.register(_HANDLE.shutdown)
        return _HANDLE


if __name__ == "__main__":
    main()
