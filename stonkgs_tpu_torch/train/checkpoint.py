"""Training checkpoints with HF-Trainer-style rotation and auto-resume.

The port of the JAX package's ``stonkgs_tpu/train/checkpoint.py``: save
every ``save_steps``, keep the newest ``save_total_limit``, resume from
the newest (the reference's ``get_last_checkpoint``,
``stonkgs_pretraining.py:96,185-186,195-212``).  The JAX package writes
Orbax checkpoints; the port has a format of its own and does not read
those (carry weights across with :mod:`stonkgs_tpu_torch.utils.convert`
or an HF export instead).

Layout: one directory a step, ``<directory>/<step>/``, holding
``tensors.pt`` (``torch.save`` of a flat ``{path: tensor}`` dict: every
leaf of the parameters, trainable and frozen, and of the optimizer's
moments, under ``params/...`` and ``opt_state/...``) and ``state.json``
(the step, the run's seed and the optimizer's step count).  A save writes
``<step>.tmp`` and renames it with ``os.replace``, so a run killed during
a save leaves a ``.tmp`` directory that :meth:`CheckpointManager.latest_step`
ignores.

The train step updates parameters and moments in place, so a save copies
every tensor before it returns: a tensor on the card is copied into a
pinned host buffer on the current stream (ordered before any later step's
writes), and only the wait for those copies and the file write go to a
background thread.

Under a mesh (a state with a ``layout``) every rank takes part in a save:
the split leaves are all-gathered and cut to their unpadded shapes, and
the main rank alone writes them, in the same single-device format; a
blocking save ends with a barrier, so no rank runs ahead of the files.  A
restore reads the full leaves on every rank and keeps each rank's slices.
So a checkpoint moves between meshes and one card.  The JAX package
writes sharded Orbax checkpoints instead.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Dict, Optional

import torch
import torch.distributed as dist

from stonkgs_tpu_torch.utils.tree import tree_flatten_with_path, tree_map_with_path

TENSORS = "tensors.pt"
STATE = "state.json"
_STEP_DIR = re.compile(r"^\d+$")


def _state_tree(state) -> dict:
    """The tensors of a train state: params and the optimizer's moments."""
    opt = {k: v for k, v in state.opt_state.items() if k != "count"}
    return {"params": state.params, "opt_state": opt}


def _leaf_path(path: str) -> str:
    """A state-tree path -> the parameter path it stores (``params/a/b`` and
    ``opt_state/mu/a/b`` -> ``a/b``), as a layout names it."""
    head, rest = path.split("/", 1)
    return rest if head == "params" else rest.split("/", 1)[1]


def _snapshot(t: torch.Tensor):
    """A host copy of ``t``: (copy, whether it is still in flight).  A
    card tensor's copy is enqueued without blocking into pinned memory."""
    t = t.detach()
    if t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host, True
    return t.clone(), False


class CheckpointManager:
    """Save, rotate and restore train states in ``directory``."""

    def __init__(self, directory: str, save_total_limit: int = 5):
        self.directory = os.path.abspath(directory)
        self.save_total_limit = save_total_limit
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def steps(self) -> list:
        """Steps of the complete checkpoints, ascending."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if _STEP_DIR.match(d)
                      and os.path.exists(os.path.join(self.directory, d, STATE)))

    def latest_step(self) -> Optional[int]:
        """The newest complete checkpoint's step, or None."""
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, *, blocking: bool = True) -> None:
        """Save ``state`` as the checkpoint of ``step`` and rotate.

        Every tensor is copied before this returns, so the caller may
        update the state in place at once.  ``blocking=False`` leaves the
        file write to a background thread; :meth:`wait` (or a later
        blocking save) makes it durable."""
        self.wait()
        flat = tree_flatten_with_path(_state_tree(state))
        layout = getattr(state, "layout", None)
        if layout is not None:
            flat = {p: layout.gather_leaf(_leaf_path(p), t) for p, t in flat.items()}
            if not layout.mesh.is_main:
                if blocking:
                    dist.barrier()
                return
        snap, on_card = {}, False
        for path, t in flat.items():
            snap[path], card = _snapshot(t)
            on_card |= card
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record()
        meta = {"step": int(step), "seed": int(state.seed),
                "count": int(state.opt_state["count"])}

        def write():
            try:
                if event is not None:
                    event.synchronize()
                self._write(step, snap, meta)
            except BaseException as e:  # noqa: BLE001 -- raised by wait()
                self._error = e

        if blocking:
            write()
            if layout is not None:
                dist.barrier()
            self._raise()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _write(self, step: int, snap: Dict[str, torch.Tensor], meta: dict) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(snap, os.path.join(tmp, TENSORS))
        with open(os.path.join(tmp, STATE), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        keep = self.save_total_limit
        for old in (self.steps()[:-keep] if keep and keep > 0 else []):
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def _raise(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint save failed: {err}") from err

    def wait(self) -> None:
        """Block until an in-flight save is on disk (raising its error)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise()

    def restore_latest(self, template_state):
        """The newest checkpoint in the template's structure, devices and
        dtypes, or None when there is none (a fresh run).

        Raises ``ValueError`` naming the paths, shapes or dtypes that
        differ when the checkpoint does not match the template."""
        step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, str(step))
        with open(os.path.join(path, STATE)) as f:
            meta = json.load(f)
        saved = torch.load(os.path.join(path, TENSORS), map_location="cpu",
                           weights_only=True)
        want = tree_flatten_with_path(_state_tree(template_state))
        layout = getattr(template_state, "layout", None)

        def full_shape(k, t):
            return tuple(t.shape) if layout is None else layout.shapes[_leaf_path(k)]

        problems = [f"missing {k}" for k in want if k not in saved]
        problems += [f"unexpected {k}" for k in saved if k not in want]
        problems += [
            f"{k}: saved {tuple(saved[k].shape)} {saved[k].dtype}, expected "
            f"{full_shape(k, t)} {t.dtype}"
            for k, t in want.items()
            if k in saved and (tuple(saved[k].shape) != full_shape(k, t)
                               or saved[k].dtype != t.dtype)]
        if problems:
            raise ValueError(
                f"checkpoint at step {step} in {self.directory} does not match the "
                f"train state ({len(problems)} differences: "
                f"{'; '.join(problems[:5])}{' ...' if len(problems) > 5 else ''}); "
                "resume with the configuration that wrote it")

        def load(p, t):
            full = saved[p]
            if layout is not None:
                full = layout.shard_leaf(_leaf_path(p), full)
            return full.to(device=t.device)

        tree = tree_map_with_path(load, _state_tree(template_state))
        opt_state = {**tree["opt_state"], "count": meta["count"]}
        return dataclasses.replace(template_state, step=meta["step"],
                                   params=tree["params"], opt_state=opt_state,
                                   seed=meta["seed"])
