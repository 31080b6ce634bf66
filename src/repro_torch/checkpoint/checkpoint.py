"""Checkpointing: an npz shard + JSON manifest, async save, restore onto a
chosen device.

The port of ``repro/checkpoint/checkpoint.py``, with the same layout on
disk, so either package restores the other's checkpoints::

    ckpt_dir/step_000100/
      manifest.json          {step, leaf paths, shapes, dtypes}
      shard_00000.npz        leaf arrays, keys with "/" written as "%"

Design points:
  * **async save** — tensors are snapshotted to host memory on the
    caller thread (a copy, so later in-place updates cannot reach the
    snapshot); the npz write happens on a background thread while
    training continues.
  * **restore onto a device** — ``restore(template, target_device=...)``
    builds tensors of the template's dtypes on that device (the
    reference's ``target_shardings`` lays leaves out over a JAX mesh;
    one card needs only a device).
  * **atomicity** — writes go to ``<dir>.tmp`` then rename; a crashed save
    never corrupts the latest complete checkpoint. The newest ``keep``
    steps are kept.

Leaves are tensors (or numpy arrays) of numpy-representable dtypes.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple (check BEFORE tuple)
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(template, flat: Dict[str, np.ndarray], device=None,
                    prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, device, f"{prefix}{k}/")
                for k, v in template.items()}
    if hasattr(template, "_fields"):  # NamedTuple (check BEFORE tuple)
        return type(template)(*[
            _unflatten_into(getattr(template, k), flat, device,
                            f"{prefix}{k}/")
            for k in template._fields])
    if isinstance(template, (list, tuple)):
        vals = [_unflatten_into(v, flat, device, f"{prefix}{i}/")
                for i, v in enumerate(template)]
        return type(template)(vals) if isinstance(template, tuple) else vals
    arr = flat[prefix[:-1]]
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(
            device=template.device if device is None else device,
            dtype=template.dtype)
    return np.asarray(arr, dtype=np.asarray(template).dtype)


def _host(x) -> np.ndarray:
    """A host copy of one leaf."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self.save_count = 0

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, blocking: bool = True) -> str:
        """Snapshot now; write now (blocking) or in background."""
        host = {k: _host(v) for k, v in _flatten(tree).items()}
        if blocking:
            return self._write(step, host)
        self.wait()  # one in-flight save at a time
        self._thread = threading.Thread(
            target=self._write, args=(step, host), daemon=True)
        self._thread.start()
        return self._path(step)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write(self, step: int, host: Dict[str, np.ndarray]) -> str:
        path = self._path(step)
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        for k, v in host.items():
            manifest["leaves"][k] = {"shape": list(v.shape),
                                     "dtype": str(v.dtype)}
        np.savez(os.path.join(tmp, "shard_00000.npz"),
                 **{k.replace("/", "%"): v for k, v in host.items()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        self.save_count += 1
        self._gc()
        return path

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None,
                target_device=None):
        """Restore into the structure of ``template``: each tensor leaf
        comes back as a tensor of its dtype, on ``target_device`` if one
        is given, else on the template leaf's device; a numpy leaf as a
        numpy array of its dtype. Returns (tree, step)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self._path(step)
        with np.load(os.path.join(path, "shard_00000.npz")) as z:
            flat = {k.replace("%", "/"): z[k] for k in z.files}
        return _unflatten_into(template, flat, target_device), step
