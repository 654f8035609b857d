"""Fault-tolerant checkpointing: async, atomic, in JAX's layout.

The port of the JAX package's ``checkpoint/manager.py``.

* **Async**: `save` copies the state to the host before it returns, then
  writes on a background thread (`san_thread`) — training never blocks on
  disk. The copy is taken first because the port updates parameters in
  place: a writer that held the tensors (on the CPU, ``.cpu()`` is the
  tensor itself) would save a later step's weights.
* **Atomic**: writes ``step_XXXX.tmp.npz``, then renames; a crash mid-write
  never corrupts the latest checkpoint.
* **JAX's layout**: one ``.npz`` keyed as the JAX manager's ``_flatten``
  keys its trees. A `TrainState` is written as JAX's ``TrainState``
  (``.params/blocks/pos0/mixer/wq`` …, super-block parameters stacked,
  ``.opt_state/mu/…``, ``.opt_state/nu/…``, ``.opt_state/step``,
  ``.step``), so a checkpoint written by either package restores in the
  other; a dict (or list) of tensors or arrays by its keys joined with
  ``/``. bfloat16 leaves are written as float32, which holds them exactly.
* **Placement**: `restore` writes into a target of the same structure, in
  place and on the target's devices and dtypes (a `TrainState`'s model
  parameters, moments and steps), and returns it.
* **Resumable data**: metadata records the step so the data pipeline can
  deterministically skip ahead (`repro_torch.data.pipeline`).
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any

import numpy as np
import torch

from repro_torch.models import weights
from repro_torch.sanitizer.threads import san_thread
from repro_torch.train.step import TrainState

__all__ = ["CheckpointManager"]


def _flat_tree(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Leaves of nested dicts / lists / tuples keyed by their path joined
    with ``/`` (JAX's dict keys and sequence indices)."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(_flat_tree(sub, f"{prefix}/{key}" if prefix else
                              str(key)))
    return out


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return weights.to_numpy(leaf)
    return np.array(leaf)  # a copy


def _state_tree(state: TrainState) -> dict:
    """JAX's ``TrainState`` tree of ``state`` as numpy (host copies)."""
    model = state.model
    return {".params": weights.params_to_numpy(model),
            ".opt_state": weights.opt_state_to_numpy(state.opt_state, model),
            ".step": weights.to_numpy(state.step).astype(np.int32)}


def _flatten(state: Any) -> dict[str, np.ndarray]:
    if isinstance(state, TrainState):
        return _flat_tree(_state_tree(state))
    return {k: _host(v) for k, v in _flat_tree(state).items()}


def _targets(target: Any) -> dict[str, tuple]:
    """Each checkpoint key of ``target`` → (the tensor to write, the index
    of its slice in the stored array or None, the stored array's shape)."""
    if not isinstance(target, TrainState):
        return {k: (v, None, tuple(v.shape))
                for k, v in _flat_tree(target).items()}
    model = target.model
    out = {".step": (target.step, None, ()),
           ".opt_state/step": (target.opt_state["step"], None, ())}
    named = [(".params", dict(model.named_parameters())),
             (".opt_state/mu", target.opt_state["mu"]),
             (".opt_state/nu", target.opt_state["nu"])]
    for prefix, tensors in named:
        for name, t in tensors.items():
            key = "/".join((prefix,) + weights.jax_path(name))
            i = weights.block_index(name)
            if i is not None:
                out.setdefault(key, []).append(
                    (t, i, (weights.stack_depth(model.cfg, name),)
                     + tuple(t.shape)))
            else:
                out[key] = (t, None, tuple(t.shape))
    return out


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread = None  # the writer (san_thread) in flight, if any

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, *, blocking: bool = False,
             extra_meta: dict | None = None) -> None:
        """Write ``state`` (a `TrainState`, or a tree of tensors / arrays)
        as checkpoint ``step``. The host copy is taken before this returns;
        the file is written on a background thread unless ``blocking``."""
        self.wait()  # at most one in-flight write
        flat = _flatten(state)
        meta = {"step": int(step), "time": time.time(), **(extra_meta or {})}

        def write():
            tmp = os.path.join(self.dir, f"step_{step:08d}.tmp.npz")
            final = os.path.join(self.dir, f"step_{step:08d}.npz")
            np.savez(tmp, **flat)
            os.rename(tmp, final)
            with open(os.path.join(self.dir, f"step_{step:08d}.json"),
                      "w") as f:
                json.dump(meta, f)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = san_thread(write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            for suffix in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.dir, f"step_{s:08d}{suffix}"))
                except FileNotFoundError:
                    pass

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for fn in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)\.npz", fn)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, step: int, target: Any) -> Any:
        """Checkpoint ``step`` written into ``target`` — a `TrainState`, or
        a tree of tensors of the stored shapes — in place, each leaf on its
        tensor's device and in its dtype. Returns ``target``. Raises
        `ValueError` when a stored leaf's shape differs from the target's
        (JAX's stacked shape for a `TrainState`'s super-block leaves)."""
        path = os.path.join(self.dir, f"step_{step:08d}.npz")
        with np.load(path) as data:
            for key, spec in _targets(target).items():
                arr = data[key]
                for t, index, shape in (spec if isinstance(spec, list)
                                        else [spec]):
                    if tuple(arr.shape) != shape:
                        raise ValueError(f"checkpoint leaf {key}: shape "
                                         f"{arr.shape} != target {shape}")
                    src = arr if index is None else arr[index]
                    t.copy_(torch.from_numpy(np.array(src)))
        return target

    def restore_latest(self, target: Any) -> tuple[int, Any] | None:
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step, target)
