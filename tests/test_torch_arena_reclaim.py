"""The port's runtime reclaims the shared-memory arena of a dead head.

The JAX package removes a session's /dev/shm files only in a clean
`shutdown()` (ray_tpu/core/object_store.py `cleanup`), so a head killed
by SIGKILL leaks its arena.  The port departs from it: a head or node
manager records its pid before it creates its arena, and the next one
to start on the host removes the files of every recorded owner that is
gone.  Here a port head in a subprocess is SIGKILLed while a second one
stays alive; the next `init()` must remove the first's arena, keep the
second's, and leave every file of the JAX package alone.
"""

import importlib
import os
import signal
import subprocess
import sys
import textwrap

import pytest

PORT = "ray_tpu" "_torch"
rt = importlib.import_module(PORT)
store_mod = importlib.import_module(f"{PORT}.core.object_store")
cfg_mod = importlib.import_module(f"{PORT}.core.config")

_HEAD = textwrap.dedent("""
    import importlib, os, sys
    rt = importlib.import_module(sys.argv[1])
    drv = rt.init(num_cpus=1, num_gpus=0, log_to_driver=False)
    print(os.path.basename(drv.session_dir), flush=True)
    sys.stdin.readline()
    rt.shutdown()
""")


def _start_head():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.Popen(
        [sys.executable, "-c", _HEAD, PORT], cwd=root,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    line = p.stdout.readline().strip()
    assert line.startswith("session-"), line
    return p, line[len("session-"):]


def _arena(session_id):
    return os.path.join("/dev/shm",
                        f"{cfg_mod.ARENA_PREFIX}-{session_id}-arena")


def test_init_reclaims_a_killed_heads_arena_and_keeps_a_live_one():
    if rt.is_initialized():
        pytest.skip("a port runtime is already up in this process")
    dead, dead_sid = _start_head()
    live, live_sid = _start_head()
    try:
        assert os.path.exists(_arena(dead_sid))
        assert os.path.exists(_arena(live_sid))
        dead.send_signal(signal.SIGKILL)
        dead.wait(timeout=30)
        # The SIGKILLed head never ran its cleanup.
        assert os.path.exists(_arena(dead_sid))
        jax_side = os.path.join(
            "/dev/shm", f"raytpu-{dead_sid}-arena")  # a JAX package name
        open(jax_side, "wb").close()
        try:
            drv = rt.init(num_cpus=1, num_gpus=0, log_to_driver=False)
            try:
                own = os.path.basename(drv.session_dir)[len("session-"):]
                assert os.path.exists(_arena(own))
                assert not os.path.exists(_arena(dead_sid))
                assert os.path.exists(_arena(live_sid))
                assert os.path.exists(jax_side)
                owners = os.listdir(store_mod._owners_dir())
                assert f"{dead_sid}.json" not in owners
                assert f"{live_sid}.json" in owners
            finally:
                rt.shutdown()
            # A clean shutdown removes its own files and its record.
            assert not os.path.exists(_arena(own))
            assert f"{own}.json" not in os.listdir(store_mod._owners_dir())
        finally:
            os.unlink(jax_side)
    finally:
        for p in (dead, live):
            if p.poll() is None:
                p.stdin.write("\n")
                p.stdin.flush()
                p.wait(timeout=60)
    assert not os.path.exists(_arena(live_sid))


def test_a_record_of_a_reused_pid_counts_as_dead(tmp_path, monkeypatch):
    """A record whose pid now names another process (start time differs)
    is reclaimed; a key passed as `keep` is not."""
    monkeypatch.setattr(store_mod, "_owners_dir", lambda: str(tmp_path))
    shm = tmp_path / "shm"
    shm.mkdir()
    for key in ("reused", "kept", "mine"):
        (shm / f"{cfg_mod.ARENA_PREFIX}-{key}-arena").write_bytes(b"x")
        store_mod.record_arena_owner(key, str(shm))
    (shm / f"{cfg_mod.ARENA_PREFIX}-reusedx-arena").write_bytes(b"x")
    import json

    rec = json.loads((tmp_path / "reused.json").read_text())
    rec["start"] = "0"  # this pid, another start: not the owner
    (tmp_path / "reused.json").write_text(json.dumps(rec))
    rec["pid"] = 2 ** 22 + 1  # above pid_max's default: no such process
    (tmp_path / "kept.json").write_text(json.dumps(rec))
    removed = store_mod.reclaim_dead_arenas(keep="kept")
    assert removed == {"reused": 1}
    assert sorted(os.listdir(shm)) == [
        f"{cfg_mod.ARENA_PREFIX}-kept-arena",
        f"{cfg_mod.ARENA_PREFIX}-mine-arena",
        f"{cfg_mod.ARENA_PREFIX}-reusedx-arena"]
