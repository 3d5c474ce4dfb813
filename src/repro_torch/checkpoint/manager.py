"""Checkpointing for the training loop.  Counterpart of
``repro.checkpoint.manager``, in its on-disk format, so that a checkpoint
written by either package restores in the other:

  * ``step_XXXXXXXXXX/leaf_XXXXX.npy``, one ``np.save`` file per leaf, in the
    order of the dotted paths (dict keys sorted, as ``jax.tree`` orders them);
  * ``manifest.json`` with the step, each leaf's dotted path, file, shape,
    dtype and crc32 of its bytes;
  * **atomic**: written under ``step_N.tmp.<process>`` and renamed to
    ``step_N`` once every file is on disk, so a crash mid-save never
    corrupts the latest checkpoint;
  * **async**: ``save`` copies the tensors to host memory on the caller's
    thread, then writes in a background thread;
  * **keep-k GC** of old steps after each successful save;
  * ``restore(like=...)`` fetches leaves by dotted path and checks their
    shapes, crc32 included.

bf16 and fp8 leaves are stored as their raw bits (a void dtype of the same
width, which is what ``np.save`` writes for the ``ml_dtypes`` types of the
JAX package) and restored bit for bit by the manifest's dtype.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.convert import from_bits, tensor_bits
from repro_torch.models.common import tree_items


class CheckpointError(RuntimeError):
    pass


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.process_index = _process_index()

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any, *, wait: bool = False) -> None:
        """Checkpoint a nested dict of tensors at ``step``.  Copies to host
        memory synchronously, writes asynchronously unless ``wait`` or sync
        mode."""
        self.wait()  # one outstanding save at a time; surfaces prior errors
        snapshot = [(path, *tensor_bits(t)) for path, t in tree_items(tree)]

        def write():
            try:
                self._write(step, snapshot)
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        if self.async_save and not wait:
            self._thread = threading.Thread(target=write, name=f"ckpt-save-{step}")
            self._thread.start()
        else:
            write()
            self.wait()

    def _write(self, step: int, snapshot) -> None:
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f"step_{step:010d}.tmp.{self.process_index}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "treedef": "torch nested dict", "leaves": [],
                    "time": time.time()}
        for i, (path, arr, dtype) in enumerate(snapshot):
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, arr, allow_pickle=False)
            manifest["leaves"].append({"path": path, "file": fname, "shape": list(arr.shape),
                                       "dtype": dtype, "crc32": _crc(arr)})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # the atomic commit
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise CheckpointError(f"save failed: {e!r}") from e

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.name.endswith(".tmp") or ".tmp." in p.name:
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, like: Any = None) -> tuple[int, Any]:
        """(step, tree) of the latest checkpoint, or of ``step``.  Without
        ``like``, the tree is ``{dotted path: numpy array}``.  With ``like``
        (a nested dict of tensors, meta tensors included), each of its leaves
        is fetched by dotted path, its shape checked, and it comes back as a
        tensor of the checkpoint's dtype on the device of the ``like`` leaf
        (the CPU for a meta leaf)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise CheckpointError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        arrays: dict[str, tuple[np.ndarray, str]] = {}
        for leaf in manifest["leaves"]:
            arr = np.load(d / leaf["file"], allow_pickle=False)
            if _crc(arr) != leaf["crc32"]:
                raise CheckpointError(f"crc mismatch for {leaf['path']} in step {step}")
            if list(arr.shape) != leaf["shape"]:
                raise CheckpointError(f"shape mismatch for {leaf['path']}")
            arrays[leaf["path"]] = (arr, leaf["dtype"])

        if like is None:
            return step, {k: a for k, (a, _) in arrays.items()}

        def fetch(path: str, ref: torch.Tensor) -> torch.Tensor:
            if path not in arrays:
                raise CheckpointError(f"missing leaf {path} in checkpoint step {step}")
            arr, dtype = arrays[path]
            if tuple(arr.shape) != tuple(ref.shape):
                raise CheckpointError(
                    f"leaf {path}: checkpoint shape {arr.shape} != expected {tuple(ref.shape)}"
                )
            device = "cpu" if ref.device.type == "meta" else ref.device
            return from_bits(arr, dtype, device)

        return step, _build(like, fetch)


def _build(like, fetch, prefix: str = ""):
    """The tree of ``like`` with each leaf replaced by ``fetch(path, leaf)``."""
    out = {}
    for k in sorted(like):
        path = f"{prefix}.{k}" if prefix else str(k)
        v = like[k]
        out[k] = _build(v, fetch, path) if isinstance(v, dict) else fetch(path, v)
    return out
