"""Checkpoint manager: atomic, async, keep-N, restore onto the current device.

Port of ``repro/checkpoint/manager.py``, with the same layout on disk: a
directory ``step_XXXXXXXX`` per checkpoint holding ``arrays.npz`` (the
state's leaves ``leaf_0`` … in order) and ``manifest.json`` (``step``,
``num_leaves``, ``extra``, and here also the leaves' ``names``).

* **Atomicity** — state is written to a unique ``step_XXXXXXXX.tmp…``
  directory and renamed; a crash mid-save never corrupts the latest
  checkpoint, and an unfinished one is never listed.
* **Async** — ``save(..., blocking=False)`` copies the tensors to the host
  at once (so the trainer may go on updating them) and hands the write to
  a writer thread; ``wait()`` blocks until it is durable and raises what
  the writer raised.
* **Keep-N** — older checkpoints are removed after each publish.
* **Restore onto the current device** — arrays are stored as host numpy
  arrays; ``restore`` copies each into the tensor of the same place in
  ``like`` (a model's parameters are written in place) on whatever device
  it lives.
* **Auto-resume** — ``latest_step`` finds the newest complete checkpoint.
* **Elastic restore** — a sharded state's ``DTensor`` leaves (a model after
  :func:`repro_torch.sharding.shard.shard_model`, its optimizer and
  error-feedback state) are saved whole: every rank joins their gathers and
  rank 0 writes, so the files hold no topology.  ``restore`` places each
  array onto whatever layout ``like`` has, another mesh or one device,
  every rank keeping its own chunk.  ``wait()`` (and a blocking ``save``)
  then holds every rank until rank 0 has published.

A state is any nesting of named tuples, tuples, lists, dicts,
``nn.Module``s (their named parameters), tensors and Python numbers, such
as :class:`repro_torch.train.train_loop.TrainState`.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.sharding import shard

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _leaves(tree, path: str = ""):
    """(path, leaf) pairs of a state in a fixed order; leaves are tensors
    and Python numbers."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield f"{path}.{name}", p
    elif torch.is_tensor(tree) or isinstance(tree, (bool, int, float, np.number)):
        yield path, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        raise TypeError(f"{path}: cannot checkpoint a {type(tree).__name__}")


def _rebuild(tree, values):
    """``tree`` with each leaf taken from the iterator ``values`` in
    :func:`_leaves` order: tensors written in place (cast to their dtype,
    on their device), numbers replaced."""
    if isinstance(tree, nn.Module):
        for _, p in tree.named_parameters():
            _place(p, next(values))
        return tree
    if torch.is_tensor(tree):
        _place(tree, next(values))
        return tree
    if isinstance(tree, (bool, int, float, np.number)):
        return type(tree)(next(values))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), values) for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _rebuild(v, values) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return tree


@torch.no_grad()
def _place(t: torch.Tensor, value: np.ndarray) -> None:
    """The saved whole ``value`` into ``t`` in place: a ``DTensor`` takes
    this rank's chunk of it in its layout."""
    full = torch.from_numpy(value)
    lay = shard.layout(t)
    if lay is not None:
        full = shard.local_chunk(full, lay[0], t.placements)
    shard.local(t).copy_(full.to(t.device, t.dtype))


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return shard.full_tensor(leaf.detach()).to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _sharded(leaves) -> bool:
    return any(torch.is_tensor(leaf) and shard.layout(leaf) is not None for _, leaf in leaves)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._sharded = False  # the last save gathered shards: rank 0 writes

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, extra: Optional[dict] = None, *, blocking: bool = True):
        """Snapshot ``state`` and ``extra`` (JSON-able) at ``step``."""
        # Materialise on the host now, so the trainer can update its state.
        leaves = list(_leaves(state))
        self._sharded = _sharded(leaves)
        payload = (step, [_host(leaf) for _, leaf in leaves], [name for name, _ in leaves], extra or {})
        if self._sharded and dist.get_rank() != 0:
            if blocking:
                dist.barrier()
            return
        if blocking:
            self._write(payload)
            if self._sharded:
                dist.barrier()
        else:
            self._ensure_worker()
            self._q.put(payload)

    def wait(self):
        """Block until every async save is durable; raise the writer's error."""
        if self._worker is not None:
            self._q.join()
        if self._sharded:
            dist.barrier()
        if self._error:
            raise self._error

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _drain(self):
        while True:
            payload = self._q.get()
            try:
                self._write(payload)
            except BaseException as e:  # surfaced on wait()
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, payload):
        step, host, names, extra = payload
        name = f"step_{step:08d}"
        # A unique tmp directory: concurrent saves of one step must not race.
        tmp = os.path.join(self.dir, f"{name}.tmp{os.getpid()}_{threading.get_ident()}")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **{f"leaf_{i}": a for i, a in enumerate(host)})
        manifest = {"step": step, "num_leaves": len(host), "extra": extra, "names": names}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            m = _STEP_RE.match(d)
            if m and os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any):
        """The state saved at ``step``, in the structure of ``like``: each
        tensor of ``like`` is overwritten in place on its own device, each
        number replaced.  Returns (state, extra)."""
        name = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(name, "manifest.json")) as f:
            manifest = json.load(f)
        names = [n for n, _ in _leaves(like)]
        if manifest["num_leaves"] != len(names) or manifest.get("names", names) != names:
            raise ValueError(
                f"checkpoint has {manifest['num_leaves']} leaves, the state expects {len(names)}: "
                "architecture or optimizer mismatch"
            )
        with np.load(os.path.join(name, "arrays.npz")) as data:
            arrays = [data[f"leaf_{i}"] for i in range(len(names))]
        return _rebuild(like, iter(arrays)), manifest["extra"]
