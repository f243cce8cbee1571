"""Checkpointing of the port in the JAX package's on-disk format, so a
checkpoint written by either package restores in the other.

A step is the directory ``ckpt_%08d`` holding ``arrays.npz`` (one array
per leaf, keyed by its tree path joined by "/": dict keys, list indices
and ".name" for the fields of ``TrainState`` / ``AdamWState``, as JAX's
``_flatten`` builds them; ``repro_torch.tree``) and ``manifest.json``
(the step, the time and each array's shape and dtype name). bfloat16 is
stored as its ``uint16`` bits and float8 as ``uint8``, the manifest
keeping the true dtype.

* atomic: written into ``ckpt_%08d.tmp``, then renamed;
* keep-N: older steps are deleted after each save;
* async: ``save(blocking=False)`` copies the tensors to the host at once
  and writes on a thread (``wait`` joins it);
* ``restore`` rebuilds a tree of the structure, dtypes and devices of its
  target, checking every shape; placement on a mesh (``shardings``) is
  not ported.

``import_hf`` saves an HF safetensors checkpoint as a native step, and
the AQUA projections live beside the steps as ``aqua_projections.npz``
(``core.calibration``'s format, the JAX package's).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib

PROJECTIONS_NAME = "aqua_projections.npz"

# dtypes numpy cannot hold -> (storage dtype of their bits, the torch
# dtype of the same width to view them through)
_VIEW_CODEC = {
    torch.bfloat16: ("bfloat16", np.uint16, torch.int16),
    torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, torch.uint8),
    torch.float8_e5m2: ("float8_e5m2", np.uint8, torch.uint8),
}
_BY_NAME = {name: dt for dt, (name, _, _) in _VIEW_CODEC.items()}


def _encode(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor -> (its host array as stored, its dtype name)."""
    t = t.detach().to("cpu", copy=True)
    codec = _VIEW_CODEC.get(t.dtype)
    if codec is None:
        arr = t.numpy()
        return arr, str(arr.dtype)
    name, store, bits = codec
    return t.contiguous().view(bits).numpy().view(store), name


def _decode(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    dt = _BY_NAME.get(dtype_name)
    if dt is None:
        return torch.from_numpy(arr)
    bits = _VIEW_CODEC[dt][2]
    return torch.from_numpy(arr.view(
        np.int16 if bits is torch.int16 else np.uint8)).view(dt)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- paths ---------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = True) -> None:
        """Write ``tree`` (a tree of tensors) as ``step``. The copy to the
        host is made before this returns, so the caller may go on updating
        the tensors in place; ``blocking=False`` writes on a thread."""
        host = {key: _encode(leaf) for key, leaf in tree_lib.items(tree)}
        if blocking:
            self._write(step, host)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: arr for k, (arr, _) in host.items()})
        manifest = {
            "step": step,
            "time": time.time(),
            "arrays": {k: {"shape": list(arr.shape), "dtype": name}
                       for k, (arr, name) in host.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------
    def restore(self, step: Optional[int], target, *, shardings=None):
        """(a tree of the structure of ``target`` holding step ``step``'s
        arrays, each cast to its target leaf's dtype and put on its device
        (the CPU for a meta tensor), step); ``step`` None is the latest.
        Raises ``FileNotFoundError`` without checkpoints and
        ``ValueError`` on a shape that differs from the target's."""
        if shardings is not None:
            raise NotImplementedError(
                "restore onto a mesh (shardings) is not ported: the port "
                "runs on one device")
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._step_dir(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["step"] == step
        with np.load(os.path.join(path, "arrays.npz")) as data:
            def load(key, leaf):
                arr = _decode(data[key], manifest["arrays"][key]["dtype"])
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"shape mismatch for {key}: "
                                     f"{tuple(arr.shape)} vs "
                                     f"{tuple(leaf.shape)}")
                dev = "cpu" if leaf.device.type == "meta" else leaf.device
                return arr.to(device=dev, dtype=leaf.dtype)
            return tree_lib.map_with_path(load, target), step

    # -- HF ingestion + AQUA projection sidecar ---------------------------
    def import_hf(self, hf_path: str, cfg, *, step: int = 0, device=None):
        """Load an HF safetensors checkpoint (``checkpoint.hf``) onto
        ``device`` (None = the CUDA card), save it as step ``step`` and
        return the param tree."""
        from repro_torch.checkpoint.hf import load_hf_checkpoint

        params = load_hf_checkpoint(hf_path, cfg, device=device)
        self.save(step, params)
        return params

    @property
    def projections_path(self) -> str:
        """The AQUA projection sidecar beside the checkpoint steps."""
        return os.path.join(self.directory, PROJECTIONS_NAME)

    def save_aqua_projections(self, proj) -> None:
        """Save ``AquaProjections`` beside the steps (tmp + rename)."""
        from repro_torch.core.calibration import save_projections

        tmp = self.projections_path + ".tmp"
        save_projections(tmp, proj)
        os.replace(tmp, self.projections_path)

    def load_aqua_projections(self, device=None):
        """The projection sidecar on ``device`` (None = the CUDA card), or
        None when absent."""
        from repro_torch.core.calibration import load_projections

        if not os.path.exists(self.projections_path):
            return None
        return load_projections(self.projections_path, device)
