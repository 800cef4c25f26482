"""Checkpoint handle + tree save/restore, on torch.

Port of ray_tpu/train/checkpoint.py.  `Checkpoint` and `StorageContext`
are copies of the reference's (its train/_checkpoint.py `Checkpoint`, a
directory handle, and train/_internal/storage.py StorageContext.
persist_current_checkpoint :508), but for the default storage path,
which is the port's own (`<tmpdir>/ray_tpu_torch/results`, beside the
runtime's sessions) so that a run of each package never shares a run
directory or its checkpoints.

The JAX package saves trees with orbax.  Here `save_pytree`,
`save_pytree_async` and `load_pytree` are written on torch, and a saved
tree is a directory of two files:

  tensors.pt  a flat {path: tensor} dict written by torch.save, one entry
              per tensor (or numpy array) of the tree, keyed by its path
              ("params/embed", "opt_state/1/0/mu/final_norm", ...);
  tree.json   the tree's structure: dicts, lists, tuples, NamedTuples
              (by name and fields) and JSON scalars (the optimizer's step
              counts), with each tensor named by its path.

Loading reads tensors.pt with `torch.load(weights_only=True)`, which
unpickles tensors and plain containers only and refuses any other
object, and rebuilds the tree from tree.json.  A NamedTuple is rebuilt
from the type of the same place in `target`, or else from the optimizer
states of `train/optim.py`; no name is ever imported.  So loading a
checkpoint directory runs no code that it holds.  `step_<n>` naming is
the reference's (`_resolve_ckpt_path`).
"""

from __future__ import annotations

import json
import mmap
import os
import re
import shutil
import struct
import tempfile
import threading
import time
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

TENSORS = "tensors.pt"
STRUCTURE = "tree.json"
_FORMAT = 1


class Checkpoint:
    """A directory of checkpoint data (framework-agnostic handle)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def as_directory(self) -> str:
        return self.path

    def to_directory(self, dest: Optional[str] = None) -> str:
        dest = dest or tempfile.mkdtemp(prefix="ckpt_")
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    # -- metrics sidecar ----------------------------------------------------
    def update_metadata(self, meta: Dict[str, Any]) -> None:
        with open(os.path.join(self.path, ".metadata.json"), "w") as f:
            json.dump(meta, f)

    def get_metadata(self) -> Dict[str, Any]:
        p = os.path.join(self.path, ".metadata.json")
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"


# ---------------------------------------------------------------------------
# Tree persistence (torch)
# ---------------------------------------------------------------------------

def _resolve_ckpt_path(directory: str, step: Optional[int]) -> str:
    """Shared sync/async step-directory naming (they must never
    diverge: a restore looks up whichever the save wrote)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    return os.path.join(directory, f"step_{step}") if step is not None \
        else directory


def _known_namedtuples() -> Dict[str, type]:
    from ray_tpu_torch.train import optim

    return {c.__name__: c for c in (optim.EmptyState,
                                    optim.ScaleByAdamState,
                                    optim.ScaleByScheduleState)}


def _flatten(node: Any, path: str, tensors: Dict[str, Any]) -> Dict:
    """The JSON structure of `node`; its tensors go into `tensors`."""
    def sub(key):
        return f"{path}/{key}" if path else str(key)

    if isinstance(node, torch.Tensor):
        tensors[path] = node
        return {"tensor": path}
    if isinstance(node, (np.ndarray, np.generic)):
        tensors[path] = torch.from_numpy(np.array(node))
        return {"ndarray": path, "scalar": isinstance(node, np.generic)}
    if isinstance(node, dict):
        for k in node:
            if not isinstance(k, str) or "/" in k:
                raise TypeError(f"checkpoint dict keys must be strings "
                                f"without '/', got {k!r} at {path!r}")
        return {"dict": {k: _flatten(v, sub(k), tensors)
                         for k, v in node.items()}}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return {"namedtuple": type(node).__name__,
                "fields": {f: _flatten(getattr(node, f), sub(f), tensors)
                           for f in node._fields}}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_flatten(v, sub(i), tensors)
                       for i, v in enumerate(node)]}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    raise TypeError(f"cannot checkpoint a {type(node).__name__} at "
                    f"{path!r}")


def flatten_pytree(tree: Any):
    """(structure, {path: tensor}) of `tree` as save_pytree writes them
    (tree.json's structure, NamedTuples by name and fields; numpy leaves
    as tensors): two trees are the same where both parts are."""
    tensors: Dict[str, torch.Tensor] = {}
    return _flatten(tree, "", tensors), tensors


def _rebuild(spec: Dict, tensors: Dict[str, torch.Tensor], like: Any,
             path: str = "") -> Any:
    """The tree `spec` describes; `like` (the target, or None) gives the
    NamedTuple types and must have the same structure."""
    def mismatch():
        return ValueError(f"checkpoint structure differs from the target "
                          f"at {path or '<root>'!r}")

    if "tensor" in spec:
        if like is not None and not isinstance(like, torch.Tensor):
            raise mismatch()
        return tensors[spec["tensor"]]
    if "ndarray" in spec:
        arr = tensors[spec["ndarray"]].cpu().numpy()
        return arr[()] if spec["scalar"] else arr
    if "value" in spec:
        return spec["value"]
    if "dict" in spec:
        items = spec["dict"]
        if like is not None and (not isinstance(like, dict)
                                 or set(like) != set(items)):
            raise mismatch()
        return {k: _rebuild(v, tensors, None if like is None else like[k],
                            f"{path}/{k}") for k, v in items.items()}
    if "namedtuple" in spec:
        name, fields = spec["namedtuple"], spec["fields"]
        if like is not None:
            cls = type(like)
            if cls.__name__ != name or not hasattr(like, "_fields"):
                raise mismatch()
        else:
            cls = _known_namedtuples().get(name)
            if cls is None:
                raise ValueError(
                    f"checkpoint names the NamedTuple {name!r} at "
                    f"{path or '<root>'!r}; pass target= with that type")
        if tuple(fields) != tuple(cls._fields):
            raise mismatch()
        return cls(*(_rebuild(v, tensors, None if like is None
                              else getattr(like, f), f"{path}/{f}")
                     for f, v in fields.items()))
    kind = "list" if "list" in spec else "tuple"
    items = spec[kind]
    if like is not None and (not isinstance(like, (list, tuple))
                             or len(like) != len(items)):
        raise mismatch()
    out = [_rebuild(v, tensors, None if like is None else like[i],
                    f"{path}/{i}") for i, v in enumerate(items)]
    return out if kind == "list" else tuple(out)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host tensor that shares nothing with `t` (a CUDA tensor is
    copied once; a CPU tensor is cloned)."""
    return t.detach().to("cpu", copy=True)


def _own_storage(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy when it views a larger storage (torch.save writes a
    view's whole storage)."""
    t = t.detach()
    whole = t.untyped_storage().nbytes() == t.numel() * t.element_size()
    return t if whole and t.is_contiguous() else t.contiguous().clone()


def _check_target(path: str, force: bool) -> None:
    if os.path.exists(path) and not force:
        raise FileExistsError(f"checkpoint {path} exists (force=False)")


def _write(path: str, spec: Dict, tensors: Dict[str, torch.Tensor],
           force: bool) -> None:
    """Write into a temporary sibling, fsync, then rename into place: a
    reader never sees a half-written checkpoint under `path`."""
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, TENSORS), "wb") as f:
        torch.save(tensors, f)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, STRUCTURE), "w") as f:
        json.dump({"format": _FORMAT, "tree": spec}, f)
        f.flush()
        os.fsync(f.fileno())
    _check_target(path, force)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    fd = os.open(os.path.dirname(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_pytree(tree: Any, directory: str, *, step: Optional[int] = None,
                force: bool = True) -> str:
    """Save a tree of tensors (CUDA or CPU), numpy arrays and scalars
    under `directory` (`step_<step>` below it when step is given)."""
    path = _resolve_ckpt_path(directory, step)
    _check_target(path, force)
    spec, tensors = flatten_pytree(tree)
    _write(path, spec, {k: _own_storage(t) for k, t in tensors.items()},
           force)
    return path


class AsyncSave:
    """Handle for an in-flight async checkpoint: every tensor was copied
    to host memory before save_pytree_async returned, and a thread writes
    the copies.  wait() blocks until the write is durable (fsynced and
    renamed into place) and re-raises the writer's error, if any."""

    def __init__(self, path: str):
        self.path = path
        self.error: Optional[BaseException] = None
        self.durable_at: Optional[float] = None  # time.time() when durable
        self._thread: Optional[threading.Thread] = None

    def _run(self, spec, snapshot, force):
        try:
            _write(self.path, spec, snapshot, force)
            self.durable_at = time.time()
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            self.error = e

    def wait(self) -> str:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            raise self.error
        return self.path


def save_pytree_async(tree: Any, directory: str, *,
                      step: Optional[int] = None,
                      force: bool = True) -> AsyncSave:
    """Start a non-blocking checkpoint save and return an AsyncSave.

    Every tensor is copied to host memory before this returns (a CUDA
    tensor by a synchronous device-to-host copy), so the train loop may
    change the tree in place at once: the file holds the values of the
    call.  The write and its fsync run on a thread, overlapping the
    loop's next steps; keep the handle and wait() before relying on the
    checkpoint."""
    path = _resolve_ckpt_path(directory, step)
    _check_target(path, force)
    spec, tensors = flatten_pytree(tree)
    snapshot = {k: _host_copy(t) for k, t in tensors.items()}
    handle = AsyncSave(path)
    handle._thread = threading.Thread(
        target=handle._run, args=(spec, snapshot, force), daemon=True,
        name=f"save_pytree_async:{os.path.basename(path)}")
    handle._thread.start()
    return handle


def load_pytree(path: str, *, target: Any = None, shardings: Any = None,
                map_location: Any = None) -> Any:
    """Restore a tree saved by save_pytree / save_pytree_async, its
    tensors on `map_location` (torch.load's, e.g. "cuda"; None: the
    device each was saved from, the CPU for save_pytree_async's host
    copies).  With `target`, the checkpoint must have its structure,
    and NamedTuples take its types.

    With `shardings`, a tree of the checkpoint's structure (NamedTuples
    included) holding a `NamedSharding` (parallel/sharding.py) or None
    at each tensor and None at each other leaf, every tensor comes back
    as this rank's block of it (`NamedSharding.block`; whole where its
    layout is None or replicated), a tensor of its own on `map_location`
    (a device; None: the CPU): the reference restores each array onto
    its NamedSharding.  tensors.pt is opened with `torch.load(mmap=True)`,
    which reads no tensor's bytes, and each block is read through a
    mapping of its leaf's bytes alone (_block_reader); no rank talks to
    another.  A dim that does not split raises
    `shard_shape`'s ValueError, and a `shardings` tree that differs
    from the checkpoint's structure a ValueError naming the first key
    that differs."""
    with open(os.path.join(path, STRUCTURE)) as f:
        meta = json.load(f)
    if meta.get("format") != _FORMAT:
        raise ValueError(f"{path}: unknown checkpoint format "
                         f"{meta.get('format')!r}")
    if shardings is None:
        tensors = torch.load(os.path.join(path, TENSORS),
                             map_location=map_location, weights_only=True)
    else:
        tensors = torch.load(os.path.join(path, TENSORS), mmap=True,
                             map_location="cpu", weights_only=True)
    if not isinstance(tensors, dict) or not all(
            isinstance(t, torch.Tensor) for t in tensors.values()):
        raise ValueError(f"{path}/{TENSORS} is not a flat dict of tensors")
    if shardings is not None:
        blocks: Dict[str, torch.Tensor] = {}
        with open(os.path.join(path, TENSORS), "rb") as f:
            _read_blocks(meta["tree"], shardings, _block_reader(f, tensors),
                         blocks, torch.device(map_location or "cpu"))
        tensors = blocks
    return _rebuild(meta["tree"], tensors, target)


def _read_blocks(spec: Dict, layout: Any, read, out: Dict[str, torch.Tensor],
                 dev: torch.device, path: str = "") -> None:
    """Walk the checkpoint's structure `spec` and the layouts `layout`
    together: each tensor's block (whole where its layout is None) read
    with `read` into a tensor of its own in `out`, on `dev` (numpy
    leaves on the CPU)."""
    from ray_tpu_torch.parallel.sharding import NamedSharding

    def differ(key: Any = None) -> ValueError:
        at = path if key is None else f"{path}/{key}" if path else str(key)
        return ValueError(f"shardings differ from the checkpoint's "
                          f"structure at {at or '<root>'!r}")

    def walk(items, layouts):
        for k, v in items:
            _read_blocks(v, layouts[k], read, out, dev,
                         f"{path}/{k}" if path else str(k))

    if "tensor" in spec or "ndarray" in spec:
        if layout is not None and not isinstance(layout, NamedSharding):
            raise differ()
        key = spec["tensor"] if "tensor" in spec else spec["ndarray"]
        out[key] = read(key, layout, dev if "tensor" in spec else "cpu")
    elif "value" in spec:
        if layout is not None:
            raise differ()
    elif "dict" in spec:
        items = spec["dict"]
        if not isinstance(layout, dict):
            raise differ()
        for k in list(items) + list(layout):
            if k not in items or k not in layout:
                raise differ(k)
        walk(items.items(), layout)
    elif "namedtuple" in spec:
        fields = spec["fields"]
        if not hasattr(layout, "_fields") or \
                type(layout).__name__ != spec["namedtuple"]:
            raise differ()
        for f, g in zip(list(fields) + [None], list(layout._fields) + [None]):
            if f != g:
                raise differ(f if f is not None else g)
        walk(fields.items(), layout._asdict())
    else:
        items = spec["list" if "list" in spec else "tuple"]
        if not isinstance(layout, (list, tuple)) or hasattr(layout,
                                                             "_fields"):
            raise differ()
        if len(layout) != len(items):
            raise differ(min(len(layout), len(items)))
        walk(enumerate(items), layout)


def _block_reader(f, tensors: Dict[str, torch.Tensor]):
    """read(key, layout, dev): the block of tensors[key] (a tensor in
    torch.load's mapping of the whole tensors.pt, whose bytes are never
    touched there) read through a mapping of that leaf's own bytes of
    the open file `f`, unmapped once the block is on `dev`.  Where a
    kernel maps all the page cache holds of a file at a mapping's first
    fault (an H100 host's sandboxed kernel, whose resident memory grew
    by the whole 7.04 GB file when the blocks were read through
    torch.load's mapping; PERF.md), a rank then holds one leaf of the
    file at a time."""
    with zipfile.ZipFile(f) as z:  # a zero-byte storage maps nothing
        records = [i.header_offset for i in z.infolist()
                   if re.search(r"/data/\d+$", i.filename) and i.file_size]
    offsets = set()
    for at in records:  # a local header: 30 bytes, the name, the extra
        f.seek(at + 26)
        name, extra = struct.unpack("<HH", f.read(4))
        offsets.add(at + 30 + name + extra)
    ptrs = [t.untyped_storage().data_ptr() for t in tensors.values()
            if t.untyped_storage().nbytes()]
    base = min(ptrs) - min(offsets) if ptrs else 0

    def read(key: str, layout, dev) -> torch.Tensor:
        like = tensors[key]
        view = like if layout is None else layout.block(like)
        nbytes = like.untyped_storage().nbytes()
        if not nbytes:
            return torch.empty(view.shape, dtype=view.dtype, device=dev)
        at = like.untyped_storage().data_ptr() - base
        if at not in offsets:
            raise ValueError(f"{key}: no record of tensors.pt holds it")
        lo = at - at % mmap.ALLOCATIONGRANULARITY
        mm = mmap.mmap(f.fileno(), at - lo + nbytes, offset=lo,
                       access=mmap.ACCESS_COPY)
        try:
            return torch.empty(view.shape, dtype=view.dtype,
                               device=dev).copy_(torch.frombuffer(
                mm, dtype=torch.uint8, count=nbytes, offset=at - lo).view(
                like.dtype).as_strided(view.shape, view.stride(),
                                       view.storage_offset()))
        finally:
            mm.close()

    return read


# ---------------------------------------------------------------------------
# Storage context: where run output lands (reference storage.py:352)
# ---------------------------------------------------------------------------

class StorageContext:
    """Filesystem layout for one run: storage_path/run_name/checkpoint_NNN."""

    def __init__(self, storage_path: Optional[str], name: Optional[str],
                 num_to_keep: Optional[int] = None):
        # The port's own default, beside its runtime's sessions.
        self.storage_path = os.path.abspath(
            storage_path or os.path.join(
                tempfile.gettempdir(), "ray_tpu_torch", "results"))
        self.name = name or f"run_{int(time.time())}"
        self.run_dir = os.path.join(self.storage_path, self.name)
        os.makedirs(self.run_dir, exist_ok=True)
        self.num_to_keep = num_to_keep
        # Resume-safe: continue numbering after any checkpoints already in
        # the run dir (a restarted attempt must never overwrite them).
        existing = self._list()
        self._seq = (
            int(os.path.basename(existing[-1]).split("_")[-1]) + 1
            if existing else 0)

    def persist_checkpoint(self, local_dir: str,
                           metrics: Optional[Dict] = None) -> Checkpoint:
        """Move a worker-local checkpoint dir into run storage."""
        dest = os.path.join(self.run_dir, f"checkpoint_{self._seq:06d}")
        self._seq += 1
        shutil.copytree(local_dir, dest, dirs_exist_ok=True)
        ckpt = Checkpoint(dest)
        if metrics:
            ckpt.update_metadata({"metrics": metrics, "time": time.time()})
        self._gc()
        return ckpt

    def latest_checkpoint(self) -> Optional[Checkpoint]:
        cks = self._list()
        return Checkpoint(cks[-1]) if cks else None

    def _list(self):
        if not os.path.isdir(self.run_dir):
            return []
        return sorted(
            os.path.join(self.run_dir, d) for d in os.listdir(self.run_dir)
            if d.startswith("checkpoint_"))

    def _gc(self):
        if self.num_to_keep is None:
            return
        cks = self._list()
        for old in cks[:max(0, len(cks) - self.num_to_keep)]:
            shutil.rmtree(old, ignore_errors=True)
