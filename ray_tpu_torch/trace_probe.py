"""Probe: which torch.profiler sessions record the card's kernels.

    python -m ray_tpu_torch.trace_probe [case ...]   (on a CUDA machine)

Each case runs in a fresh process, as a worker of the runtime is one:
CUDA is initialized, a CUDA graph of bf16 matmuls is captured, and a work
thread replays it back to back (as an engine thread does) while profiler
sessions of 0.5 s are taken: the first while the card is busy (or idle,
in "idle-first"), a second right after it, a third 2 s later.  Unless a
case says otherwise a session is taken from a thread started for it, as
the runtime's profile op does.  The child prints one JSON line per
session as it ends (the seconds of its prepare, start, window, stop and
export steps and the kernel events in the Chrome trace it wrote), so a
case that hangs still shows how far it got; the parent gives each case
90 s.

Cases (all by default):
  idle-first       the first session over an idle card, then busy ones;
  busy-first       every session over a busy card (graph replays);
  busy-first-eager the same work launched eagerly, no graph;
  teardown0        busy-first with TEARDOWN_CUPTI=0 in the environment
                   (Kineto then keeps CUPTI between sessions);
  warmup           a zero-length session from the main thread right after
                   CUDA init, before the work starts, then busy-first;
  prepare          only the profiler's prepare step from the main thread
                   right after CUDA init, then busy-first;
  owner-thread     busy-first, each session entered and left by the work
                   thread itself;
  main-thread      busy-first, each session taken from the main thread;
  idle-first-t0    idle-first with TEARDOWN_CUPTI=0;
  early-t0         a zero-length session asking for CPU and CUDA activity
                   from the main thread BEFORE CUDA is initialized (it
                   must leave CUDA uninitialized), then busy-first, with
                   TEARDOWN_CUPTI=0;
  early-cpu-t0     the same with a CPU-only zero-length session.

Cases whose name ends in "t0" and "teardown0" run with TEARDOWN_CUPTI=0.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

CASES = ("idle-first", "busy-first", "busy-first-eager", "teardown0",
         "warmup", "prepare", "owner-thread", "main-thread",
         "idle-first-t0", "early-t0", "early-cpu-t0")
CASE_TIMEOUT_S = 90
WINDOW_S = 0.5
_KERNEL = re.compile(rb'"cat"\s*:\s*"kernel"')


def _count_kernels(path: str) -> int:
    with open(path, "rb") as f:
        return len(_KERNEL.findall(f.read()))


def _trace(out_dir: str, name: str, body) -> dict:
    """One session around body(); returns the seconds of its steps and
    the kernel events of the trace it wrote."""
    from torch.profiler import ProfilerActivity
    from torch.profiler.profiler import _KinetoProfile

    prof = _KinetoProfile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])
    t = [time.perf_counter()]
    prof.prepare_trace()
    t.append(time.perf_counter())
    prof.start_trace()
    t.append(time.perf_counter())
    body()
    t.append(time.perf_counter())
    prof.stop_trace()
    t.append(time.perf_counter())
    path = os.path.join(out_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    t.append(time.perf_counter())
    steps = ("prepare", "start", "window", "stop", "export")
    return dict(session=name, thread=threading.current_thread().name,
                kernels=_count_kernels(path),
                **{f"{s}_s": round(b - a, 3)
                   for s, a, b in zip(steps, t, t[1:])})


def _on_thread(fn):
    """fn() on a thread started for it (the runtime's profile op)."""
    res = []
    th = threading.Thread(target=lambda: res.append(fn()), name="profile")
    th.start()
    th.join(CASE_TIMEOUT_S)
    return res[0] if res else dict(session="?", hung=True)


class _Work:
    """A thread that keeps the card busy until stopped."""

    def __init__(self, graph: bool):
        import torch

        self.a = torch.randn(4096, 4096, device="cuda",
                             dtype=torch.bfloat16)
        self.b = [torch.empty_like(self.a) for _ in range(20)]
        self.graph = None
        if graph:
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                self._body()  # warm-up outside the capture
            torch.cuda.current_stream().wait_stream(s)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._body()
        torch.cuda.synchronize()
        self.busy = threading.Event()
        self.stop = threading.Event()
        self.requests: list = []  # (fn, done Event, result list)
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _body(self):
        import torch

        x = self.a
        for out in self.b:
            torch.matmul(x, self.a, out=out)
            x = out

    def _loop(self):
        import torch

        ev = torch.cuda.Event()
        while not self.stop.is_set():
            if not self.busy.is_set():
                time.sleep(0.005)
                continue
            if self.requests:
                fn, done, res = self.requests.pop(0)
                res.append(fn(self._run_for))
                done.set()
                continue
            self._step(ev)

    def _step(self, ev):
        if self.graph is not None:
            self.graph.replay()
        else:
            self._body()
        ev.record()
        ev.synchronize()

    def _run_for(self, seconds: float):
        import torch

        ev = torch.cuda.Event()
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            self._step(ev)

    def on_owner(self, fn):
        """Run fn(run_for) on the work thread, between two steps."""
        done, res = threading.Event(), []
        self.requests.append((fn, done, res))
        done.wait(120)
        return res[0]


def _emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def run_case(case: str) -> None:
    import torch

    out_dir = tempfile.mkdtemp(prefix="trace_probe_")
    if case.startswith("early"):
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if case == "early-t0":
            acts.append(ProfilerActivity.CUDA)
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts):
            pass
        _emit(dict(session="early", seconds=round(
            time.perf_counter() - t0, 3), activities=len(acts),
            cuda_initialized=torch.cuda.is_initialized()))
    t0 = time.perf_counter()
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    _emit(dict(case=case, cuda_init_s=round(time.perf_counter() - t0, 3),
               teardown_cupti=os.environ.get("TEARDOWN_CUPTI"),
               torch=torch.__version__, cuda=torch.version.cuda,
               card=torch.cuda.get_device_name(0)))
    if case == "warmup":
        _emit(_trace(out_dir, "warmup", lambda: None))
    elif case == "prepare":
        from torch.profiler import ProfilerActivity
        from torch.profiler.profiler import _KinetoProfile

        t0 = time.perf_counter()
        _KinetoProfile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]).prepare_trace()
        _emit(dict(session="prepare only",
                   prepare_s=round(time.perf_counter() - t0, 3)))
    work = _Work(graph=case != "busy-first-eager")

    def window():
        time.sleep(WINDOW_S)

    def session(name, busy=True):
        if busy:
            work.busy.set()
            time.sleep(0.2)  # the work is running before the session
        if case == "owner-thread":
            return work.on_owner(lambda run_for: _trace(
                out_dir, name, lambda: run_for(WINDOW_S)))
        if case == "main-thread":
            return _trace(out_dir, name, window)
        return _on_thread(lambda: _trace(out_dir, name, window))

    idle = case.startswith("idle-first")
    _emit(session("s1-idle" if idle else "s1", busy=not idle))
    _emit(session("s2"))
    time.sleep(2.0)
    _emit(session("s3"))
    work.stop.set()
    work.thread.join(30)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--case":
        run_case(sys.argv[2])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("trace_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    for case in sys.argv[1:] or CASES:
        env = dict(os.environ)
        env.pop("TEARDOWN_CUPTI", None)
        if case.endswith(("t0", "teardown0")):
            env["TEARDOWN_CUPTI"] = "0"
        t0 = time.perf_counter()
        try:
            p = subprocess.run(
                [sys.executable, "-m", "ray_tpu_torch.trace_probe",
                 "--case", case], env=env, capture_output=True, text=True,
                timeout=CASE_TIMEOUT_S)
            out, rc = p.stdout, p.returncode
        except subprocess.TimeoutExpired as e:
            out = (e.stdout or b"").decode() if isinstance(
                e.stdout, bytes) else (e.stdout or "")
            rc = "timeout"
        print(f"== {case} ({time.perf_counter() - t0:.1f} s, exit {rc})",
              flush=True)
        for line in out.strip().splitlines():
            print(f"   {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
