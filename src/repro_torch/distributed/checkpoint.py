"""Checkpoints with atomic commit, per-array checksums and async writes.

The on-disk layout of ``repro.distributed.checkpoint``, so a checkpoint
written by either package restores in the other::

    <root>/step_<n>.tmp/            # written first
        meta.json                   # step, tree structure, dtypes, shapes,
                                    # crc32s (and keys, for a flat dict)
        arr_<i>.npy                 # one file per leaf, in JAX's flatten order
        extra.json                  # caller state (data step, build signature)
    <root>/step_<n>/                # atomic rename on success

Fault-tolerance contract:

* a crash mid-write leaves only a ``.tmp`` dir, which restore ignores;
* every array's crc32 is recorded in ``meta.json`` at save time and
  verified at restore time: a torn or bit-rotted array raises
  :class:`CheckpointCorruptionError`, and :meth:`Checkpointer.restore_latest`
  falls back to the prior committed step;
* a non-blocking save writes on a thread; its error is raised by the next
  save or :meth:`Checkpointer.wait`.

A payload is any tree of the reference's kinds (dicts, tuples, lists,
NamedTuples such as ``(params, AdamState)``; :mod:`repro_torch.tree`)
whose leaves are tensors, numpy arrays or scalars, its leaves stored in
JAX's flatten order.  bf16 leaves are stored as a ``uint16`` view with the
dtype ``"bfloat16"``, as the reference stores them.  :meth:`Checkpointer.restore` puts
the leaves back into the structure of a ``like`` tree, each a tensor on its
``like`` leaf's device, then applies ``shard_fn``; without ``like``, a flat
dict (the index builds' payload, whose keys ``meta.json`` records) comes
back as numpy arrays.  A non-blocking save copies every leaf to the host
before it returns, so a caller may update its tensors in place at once.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_unflatten

MASK = 0xFFFFFFFF
# dtypes numpy lacks, stored as an unsigned view of their width:
# torch dtype -> (stored name, torch integer view, numpy stored dtype,
# numpy dtype torch.from_numpy takes)
_VIEWS = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16, np.int16)}
_FROM_VIEW = {v[0]: (v[3], dt) for dt, v in _VIEWS.items()}


class CheckpointCorruptionError(RuntimeError):
    """A committed checkpoint failed checksum or structural verification."""


def _to_numpy(x) -> Tuple[np.ndarray, str]:
    """A host copy of ``x`` (never sharing its memory) and its dtype name."""
    if torch.is_tensor(x):
        t = x.detach()
        view = _VIEWS.get(t.dtype)
        if view is not None:
            t = t.view(view[1])
        arr = t.cpu().numpy()
        if not x.is_cuda:
            arr = arr.copy()
        if view is not None:
            return arr.view(view[2]), view[0]
        return arr, str(arr.dtype)
    arr = np.array(x, copy=True)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, like) -> Any:
    """A stored array as ``like`` holds it: a tensor on ``like``'s device
    (bf16 from its view), else the numpy array."""
    if not torch.is_tensor(like):
        return arr
    if dtype in _FROM_VIEW:
        np_view, dt = _FROM_VIEW[dtype]
        return torch.from_numpy(arr.view(np_view)).view(dt).to(like.device)
    return torch.from_numpy(arr).to(like.device)


def _crc(arr: np.ndarray) -> int:
    """crc32 over the array's raw bytes: an integrity check against torn
    writes and bit rot, not an authenticity one."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & MASK


def serialize_key(key) -> dict:
    """JSON-safe form of a port PRNG key (``int64[2]``, the two uint32
    words): ``{"impl": None, "data": [w0, w1]}``, what
    ``repro.distributed.checkpoint.serialize_key`` writes for a raw key."""
    data = torch.as_tensor(key).to(torch.int64).cpu() & MASK
    return dict(impl=None, data=[int(w) for w in data.reshape(-1)])


def deserialize_key(fp: dict) -> torch.Tensor:
    """Inverse of :func:`serialize_key`: the key as ``int64[2]`` on the
    CPU.  A typed key the reference wrote is accepted if its
    implementation is threefry, whose key data are the same two words."""
    impl = fp.get("impl")
    if impl and "threefry" not in str(impl):
        raise ValueError(f"unsupported PRNG implementation {impl!r}")
    return torch.tensor([int(w) & MASK for w in fp["data"]],
                        dtype=torch.int64)


class Checkpointer:
    """Atomic-commit checkpoint store under ``root``.

    ``pre_commit(step)`` is called after a step's files are written and
    *before* the atomic rename: fault-injection tests
    (:mod:`repro_torch.testing.faults`) raise there to model a crash
    mid-write, which must leave only an ignored ``.tmp`` dir.  ``keep`` is
    the number of committed steps kept.
    """

    def __init__(self, root: str, *, keep: int = 3,
                 pre_commit: Optional[Callable[[int], None]] = None):
        self.root = root
        self.keep = keep
        self.pre_commit = pre_commit
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             *, blocking: bool = True) -> None:
        """Commit the tree ``tree`` and the JSON-safe ``extra`` as step
        ``step``.  The leaves are copied to the host before this returns,
        also when ``blocking`` is False."""
        leaves, treedef = tree_flatten(tree)
        host = [_to_numpy(x) for x in leaves]
        arrays = [a for a, _ in host]
        meta = dict(
            step=step,
            treedef=repr(treedef),
            dtypes=[d for _, d in host],
            shapes=[list(a.shape) for a in arrays],
            checksums=[_crc(a) for a in arrays],
        )
        if isinstance(tree, dict) and all(isinstance(k, str) for k in tree):
            # a flat dict restores without a `like` tree: the keys in the
            # order tree_flatten used (sorted) map back to arr_<i>
            meta["keys"] = sorted(tree)
        extra = extra or {}

        def write():
            tmp = os.path.join(self.root, f"step_{step}.tmp")
            final = os.path.join(self.root, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for i, arr in enumerate(arrays):
                np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            with open(os.path.join(tmp, "extra.json"), "w") as f:
                json.dump(extra, f)
            if self.pre_commit is not None:
                self.pre_commit(step)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)  # atomic commit
            self._gc()

        if blocking:
            write()
            return
        self.wait()

        def run():
            try:
                write()
            except BaseException as e:  # raised again by the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join a non-blocking save; raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        """Committed step numbers, ascending (``.tmp`` dirs excluded)."""
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_meta(self, step: int) -> dict:
        with open(os.path.join(self.root, f"step_{step}", "meta.json")) as f:
            return json.load(f)

    def read_extra(self, step: int) -> dict:
        with open(os.path.join(self.root, f"step_{step}", "extra.json")) as f:
            return json.load(f)

    def verify_step(self, step: int) -> bool:
        """True iff every array of the committed step matches its shape and
        recorded checksum."""
        try:
            self._load_arrays(step)
        except (CheckpointCorruptionError, OSError, ValueError, KeyError):
            return False
        return True

    def _load_arrays(self, step: int) -> Tuple[dict, List[np.ndarray]]:
        d = os.path.join(self.root, f"step_{step}")
        meta = self.read_meta(step)
        checksums = meta.get("checksums")
        arrays: List[np.ndarray] = []
        for i, shape in enumerate(meta["shapes"]):
            try:
                arr = np.load(os.path.join(d, f"arr_{i}.npy"))
            except (OSError, ValueError) as e:
                raise CheckpointCorruptionError(
                    f"step {step}: arr_{i}.npy unreadable: {e}") from e
            if list(arr.shape) != shape:
                raise CheckpointCorruptionError(
                    f"step {step}: arr_{i}.npy shape {arr.shape} != "
                    f"recorded {shape}")
            if checksums is not None and _crc(arr) != checksums[i]:
                raise CheckpointCorruptionError(
                    f"step {step}: arr_{i}.npy failed its checksum")
            arrays.append(arr)
        return meta, arrays

    def restore(self, step: int, like: Any = None,
                shard_fn: Optional[Callable[[Any], Any]] = None,
                ) -> Tuple[Any, dict]:
        """``(tree, extra)`` of a committed step, every array verified.

        With ``like``, the leaves fill ``like``'s structure, each a tensor
        on its ``like`` leaf's device (a numpy array where that leaf is not
        a tensor); without it, a flat dict payload comes back as numpy
        arrays by its saved keys.  ``shard_fn(tree) -> tree`` then places
        the leaves (the elastic restart's hook)."""
        meta, arrays = self._load_arrays(step)
        if like is None:
            keys = meta.get("keys")
            if keys is None:
                raise ValueError(
                    f"step {step} was not saved as a flat dict; pass `like`")
            tree = dict(zip(keys, arrays))
        else:
            like_leaves, treedef = tree_flatten(like)
            if len(like_leaves) != len(arrays):
                raise ValueError(
                    f"step {step} holds {len(arrays)} arrays, `like` "
                    f"{len(like_leaves)} leaves")
            tree = tree_unflatten(treedef, [
                _from_numpy(a, d, lk) for a, d, lk in
                zip(arrays, meta["dtypes"], like_leaves)])
        if shard_fn is not None:
            tree = shard_fn(tree)
        return tree, self.read_extra(step)

    def restore_latest(
        self, like: Any = None,
        shard_fn: Optional[Callable[[Any], Any]] = None,
        predicate: Optional[Callable[[dict], bool]] = None,
    ) -> Optional[Tuple[int, Any, dict]]:
        """Restore the newest committed step that verifies.

        Walks committed steps newest first, skips any whose ``extra`` fails
        ``predicate``, and on a checksum or structure failure falls back to
        the prior committed step instead of raising.  Returns ``(step,
        tree, extra)``, or ``None`` when no step survives.
        """
        for step in reversed(self.all_steps()):
            if predicate is not None:
                try:
                    if not predicate(self.read_extra(step)):
                        continue
                except (OSError, ValueError):
                    continue
            try:
                tree, extra = self.restore(step, like, shard_fn=shard_fn)
            except (CheckpointCorruptionError, OSError, ValueError):
                continue
            return step, tree, extra
        return None
