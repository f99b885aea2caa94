"""Background checkpoint writer with retention.

Counterpart of ``hsimae_tpu/checkpoints/orbax_io.py::OrbaxCheckpointer``
without orbax, which the card's machine lacks. The synchronous backend
(:mod:`hsimae_tpu_torch.checkpoints.io`) copies the train state to the host
and writes it on the training thread, stalling the step loop for the whole
write. Here:

* :meth:`AsyncCheckpointer.save` snapshots the model's state dict and the
  optimizer's moments into new host memory (for a CUDA state: one gather on
  the device and one copy into a pinned buffer a dtype) enqueued on the
  current stream, records a CUDA event and returns.
  The optimizer updates parameters and moments in place on the same stream,
  so the copies, enqueued before the next step, read the state of this
  step; the writer thread waits on the event before it reads the host
  memory;
* a background thread writes ``<directory>/<step>/state.pt`` (``model``,
  ``optimizer``, ``step``) with ``torch.save`` to a temporary name, then
  ``os.replace``, and deletes all but the newest ``max_to_keep`` step
  directories (``None`` or 0 keeps all);
* :meth:`AsyncCheckpointer.wait` blocks until every enqueued save is on
  disk (and raises a writer's error); :meth:`AsyncCheckpointer.close` waits
  and stops the thread. The class is a context manager.

Step directories are named like orbax's, so a workdir written by one
backend is told from the other's (``ckpt_{step}.pt`` files).
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional

import torch

STATE_FILE = "state.pt"


def _leaves(tree, out: list) -> list:
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


def _snapshot(tree):
    """``tree`` with every tensor copied to new host memory: a CPU tensor
    cloned now; the CUDA tensors of each dtype gathered by one ``torch.cat``
    on the current stream and copied, non-blocking, into one pinned buffer
    of that dtype (one storage a dtype, which ``torch.save`` requires)."""
    groups = {}
    for t in {id(t): t for t in _leaves(tree, []) if t.is_cuda}.values():
        groups.setdefault(t.dtype, []).append(t)
    slots = {}
    for dtype, card in groups.items():
        flat = torch.cat([t.detach().reshape(-1) for t in card])
        host = torch.empty(flat.numel(), dtype=dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        offset = 0
        for t in card:
            slots[id(t)] = host[offset:offset + t.numel()].view(t.shape)
            offset += t.numel()

    def copy(node):
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        if not isinstance(node, torch.Tensor):
            return node
        return slots[id(node)] if node.is_cuda else node.detach().clone()

    return copy(tree)


def checkpoint_steps(directory: str) -> List[int]:
    """Steps of the complete checkpoints in ``directory``, ascending."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(int(n) for n in names
                  if n.isdigit() and os.path.isfile(os.path.join(directory, n, STATE_FILE)))


class AsyncCheckpointer:
    """Step-keyed checkpoints written in the background, the newest
    ``max_to_keep`` kept: ``save``, ``latest_step``, ``restore_latest``,
    ``wait``, ``close``."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep or None
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: List[Future] = []

    def save(self, step: int, model: torch.nn.Module, optimizer) -> None:
        """Snapshot ``model`` and ``optimizer`` at ``step`` and enqueue the
        write; returns before the file exists (see :meth:`wait`)."""
        weights = model.state_dict()
        card = next((t.device for t in weights.values() if t.is_cuda), None)
        state = _snapshot({"model": weights, "optimizer": optimizer.state_dict(cpu=False),
                           "step": int(step)})
        event = None
        if card is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(card))
        self._pending.append(self._pool.submit(self._write, int(step), state, event))

    def _write(self, step: int, state: dict, event) -> None:
        if event is not None:
            event.synchronize()  # the snapshot's copies have landed in host memory
        path = os.path.join(self.directory, str(step))
        os.makedirs(path, exist_ok=True)
        final = os.path.join(path, STATE_FILE)
        torch.save(state, final + ".tmp")
        os.replace(final + ".tmp", final)
        if self.max_to_keep:
            for old in checkpoint_steps(self.directory)[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = checkpoint_steps(self.directory)
        return steps[-1] if steps else None

    def restore_latest(self, model: torch.nn.Module, optimizer) -> Optional[int]:
        """Load the newest checkpoint into ``model`` (strict) and
        ``optimizer``; returns its step, or None when there is none."""
        step = self.latest_step()
        if step is None:
            return None
        ck = torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                        map_location="cpu", weights_only=True)
        model.load_state_dict(ck["model"], strict=True)
        optimizer.load_state_dict(ck["optimizer"])
        return int(ck["step"])

    def wait(self) -> None:
        """Block until every enqueued save is on disk; a writer's error is
        raised here."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
