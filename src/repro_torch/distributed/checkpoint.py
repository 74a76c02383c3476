"""Checkpoints with atomic commit, per-array checksums and async writes.

The on-disk layout of ``repro.distributed.checkpoint``, so a build
checkpoint written by either package restores in the other::

    <root>/step_<n>.tmp/            # written first
        meta.json                   # step, keys, dtypes, shapes, crc32s
        arr_<i>.npy                 # one file per array, keys in sorted order
        extra.json                  # caller state (build signature, stats)
    <root>/step_<n>/                # atomic rename on success

Fault-tolerance contract:

* a crash mid-write leaves only a ``.tmp`` dir, which restore ignores;
* every array's crc32 is recorded in ``meta.json`` at save time and
  verified at restore time: a torn or bit-rotted array raises
  :class:`CheckpointCorruptionError`, and :meth:`Checkpointer.restore_latest`
  falls back to the prior committed step;
* a non-blocking save writes on a thread; its error is raised by the next
  save or :meth:`Checkpointer.wait`.

Payloads are flat dicts of arrays (tensors or numpy arrays), the form the
index builds commit; restore returns numpy arrays.  The reference's
``like`` trees, bf16 leaves and re-sharding onto a JAX mesh serve its
training checkpoints and have no counterpart here.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF


class CheckpointCorruptionError(RuntimeError):
    """A committed checkpoint failed checksum or structural verification."""


def _to_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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
    def save(self, step: int, tree: Dict[str, object],
             extra: Optional[dict] = None, *, blocking: bool = True) -> None:
        """Commit the flat dict ``tree`` (arrays by string key) and the
        JSON-safe ``extra`` as step ``step``.  The arrays are copied to the
        host before this returns, also when ``blocking`` is False."""
        if not isinstance(tree, dict) or not all(
                isinstance(k, str) for k in tree):
            raise TypeError("a checkpoint payload is a dict keyed by str")
        keys = sorted(tree)
        arrays = [_to_numpy(tree[k]) for k in keys]
        meta = dict(
            step=step,
            dtypes=[str(a.dtype) for a in arrays],
            shapes=[list(a.shape) for a in arrays],
            checksums=[_crc(a) for a in arrays],
            keys=keys,
        )
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

    def restore(self, step: int) -> Tuple[Dict[str, np.ndarray], dict]:
        """``(tree, extra)`` of a committed step, every array verified; the
        tree maps the saved keys to numpy arrays."""
        meta, arrays = self._load_arrays(step)
        keys = meta.get("keys")
        if keys is None:
            raise ValueError(f"step {step} was not saved as a flat dict")
        return dict(zip(keys, arrays)), self.read_extra(step)

    def restore_latest(
        self, predicate: Optional[Callable[[dict], bool]] = None,
    ) -> Optional[Tuple[int, Dict[str, np.ndarray], dict]]:
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
                tree, extra = self.restore(step)
            except (CheckpointCorruptionError, OSError, ValueError):
                continue
            return step, tree, extra
        return None
