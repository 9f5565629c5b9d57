"""Checkpoint store: ``<checkpoint_path>/<run_id>/<step>/state.npz``.

Each step directory holds one ``.npz`` with the state's trees flattened to
``/``-joined names (``params/head1_conv0/w`` ...), tensors as this package
keeps them (conv kernels OIHW).  A training state has the JAX package's
layout: ``params`` (the trainable partition), ``frozen``, ``stats``, ``opt``
(Adam's ``mu`` and ``nu`` trees and its ``count``) and ``step``; integers
are stored as 0-d arrays.  ``resume='last'`` restores the newest
step; at most ``max_to_keep`` steps are kept; a config JSON snapshot can be
written next to the checkpoints.
"""

from __future__ import annotations

import datetime
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_STATE_FILE = "state.npz"


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, name + "/"))
        else:
            flat[name] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return flat


class CheckpointStore:
    def __init__(self, root: str, run_id: str, max_to_keep: int = 1):
        self.dir = os.path.abspath(os.path.join(root, run_id))
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)

    def save_config_snapshot(self, config) -> str:
        stamp = datetime.datetime.now().isoformat().split(".")[0]
        path = os.path.join(self.dir, f"config_{stamp}.json")
        with open(path, "w") as f:
            f.write(config.to_json())
        return path

    def all_steps(self) -> List[int]:
        return sorted(
            int(d) for d in os.listdir(self.dir)
            if d.isdigit() and os.path.exists(os.path.join(self.dir, d, _STATE_FILE))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any]):
        """Write ``state`` (a dict of trees of tensors) as step ``step``.
        Saving an existing step is a no-op: an interval save and an exit
        save can coincide."""
        if step in self.all_steps():
            return
        tmp = os.path.join(self.dir, f".tmp_{step}_{os.getpid()}")
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, _STATE_FILE), **_flatten(state))
        os.replace(tmp, os.path.join(self.dir, str(step)))
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.dir, str(old)))

    def restore(self, state_like: Dict[str, Any], step: Any = "last"):
        """Restore a whole training state (params, frozen, stats, opt, step)
        into the structure of ``state_like``: tensors as CPU tensors, int
        leaves as ints.  Returns (state, step)."""
        return self.restore_partial(state_like, step)

    def restore_partial(self, like: Dict[str, Any], step: Any = "last"):
        """Restore the trees named by the top-level keys of ``like`` (e.g.
        params/frozen/stats for inference) as CPU tensors (an int leaf of
        ``like`` comes back as an int).

        Every leaf of ``like`` must be in the checkpoint with the same
        shape; a checkpoint of a different model variant (e.g. det convs 21
        vs 42 wide) fails here, loudly, with the offending leaves named.
        """
        if step == "last":
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, str(int(step)), _STATE_FILE)
        mismatches = []
        with np.load(path) as saved:
            missing = [k for k in like
                       if not any(n == k or n.startswith(k + "/") for n in saved.files)]
            if missing:
                raise KeyError(f"checkpoint at step {step} lacks keys {missing}")

            def leaf(name, want):
                got = saved[name] if name in saved.files else None
                ws = () if isinstance(want, int) else tuple(want.shape)
                gs = None if got is None else got.shape
                if ws != gs:
                    mismatches.append(f"{name}: checkpoint {gs} vs model {ws}")
                    return None
                return int(got) if isinstance(want, int) else torch.from_numpy(got)

            def restore(tree, prefix):
                return {k: restore(want, f"{prefix}{k}/") if isinstance(want, dict)
                        else leaf(f"{prefix}{k}", want) for k, want in tree.items()}

            out = restore(like, "")
        if mismatches:
            raise ValueError(
                f"checkpoint at step {step} does not match this model's "
                f"shapes — wrong variant or config? "
                + "; ".join(mismatches[:5])
                + (f" (+{len(mismatches) - 5} more)" if len(mismatches) > 5 else "")
            )
        return out, int(step)
