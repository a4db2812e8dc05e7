"""Checkpoint / resume in a plain single-process format (SURVEY.md §5,
§2.3 #15).

The reference uses `tf.train.Saver` keeping only the best-val snapshot.
Here each checkpoint is a directory holding one `.npy` file per array leaf
of {params, opt_state}, named by the leaf's key path, plus `meta.json` with
the scalars (step, data-iterator state, best-val metric). Retention:
`latest` (for crash resume) + `best` (by val AUC, for final test).

Commit protocol: a save snapshots every leaf to host memory, then a
background thread writes a fresh version directory and atomically swaps
the `<name>` symlink onto it, so a reader sees either the old checkpoint
or the new one, never a partial write. Restore puts each leaf onto the
template leaf's sharding, so row-sharded tables restore straight onto a
mesh (only the local process's devices are involved: one process).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
import threading
import uuid
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_META = "meta.json"
_SCALARS = ("step", "it_epoch", "it_pos", "best_val")


def _leaf_name(path) -> str:
    """File stem for a leaf: its key path joined with dots, e.g.
    `params.tables.user_table` or `opt_state.0.mu.tables.user_table`."""
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            parts.append(str(k))
    return re.sub(r"[^A-Za-z0-9_.-]", "_", ".".join(parts))


def _arrays(state) -> dict:
    return {"params": state.params, "opt_state": state.opt_state}


class CheckpointManager:
    """Holds a `latest` and a `best` checkpoint under one directory.

    In-flight saves are tracked per directory for the whole process, so a
    second manager on the same directory (e.g. a server restoring what the
    trainer just saved) waits for them before it reads."""

    _inflight: dict = {}                 # directory -> Future of its save
    _inflight_lock = threading.Lock()

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, name: str, state, it_state: Tuple[int, int],
             best_val: float, step: int, block: bool = False) -> None:
        """Async save: the arrays are copied to host here, the files are
        written in a background thread, so the step stream resumes
        immediately. Waits for the previous in-flight save first (and
        re-raises its error, if any); block=True also waits for this one."""
        self.wait()
        leaves = jax.tree_util.tree_leaves_with_path(_arrays(state))
        for _, v in leaves:
            if isinstance(v, jax.Array) and not v.is_fully_addressable:
                raise ValueError("single-process checkpoint format: every "
                                 "array must be addressable by this process")
        host = [(_leaf_name(p), np.asarray(jax.device_get(v)))
                for p, v in leaves]
        meta = {"step": int(step), "it_epoch": int(it_state[0]),
                "it_pos": int(it_state[1]), "best_val": float(best_val)}
        fut = self._pool.submit(self._write, name, host, meta)
        with self._inflight_lock:
            self._inflight[self.directory] = fut
        if block:
            self.wait()

    def _write(self, name: str, host, meta: dict) -> None:
        version = f".{name}.{uuid.uuid4().hex}"
        vdir = self._path(version)
        os.makedirs(vdir)
        for stem, arr in host:
            np.save(os.path.join(vdir, stem + ".npy"), arr,
                    allow_pickle=False)
        with open(os.path.join(vdir, _META), "w") as f:
            json.dump(meta, f)
        link = self._path(name)
        old = os.readlink(link) if os.path.islink(link) else None
        tmp_link = self._path(f".{name}.link-{uuid.uuid4().hex}")
        os.symlink(version, tmp_link)
        os.replace(tmp_link, link)            # the atomic commit
        if old is not None:
            shutil.rmtree(self._path(old), ignore_errors=True)

    def wait(self) -> None:
        """Block until any in-flight async save to this directory has
        committed to disk (re-raising its error, if it failed)."""
        with self._inflight_lock:
            fut = self._inflight.pop(self.directory, None)
        if fut is not None:
            fut.result()

    def restore(self, name: str, state) -> Optional[dict]:
        """Restore into the structure and shardings of `state`. Returns the
        payload dict ({params, opt_state} + the scalars) or None when there
        is no such checkpoint."""
        self.wait()
        path = self._path(name)
        if not os.path.exists(path):
            return None

        def load(p, tmpl):
            arr = np.load(os.path.join(path, _leaf_name(p) + ".npy"),
                          allow_pickle=False)
            if np.shape(tmpl) != arr.shape:
                raise ValueError(f"checkpoint leaf {_leaf_name(p)} has shape "
                                 f"{arr.shape}, template {np.shape(tmpl)}")
            if isinstance(tmpl, jax.Array):
                return jax.device_put(arr.astype(tmpl.dtype), tmpl.sharding)
            return arr
        out = jax.tree_util.tree_map_with_path(load, _arrays(state))
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        out.update({k: np.asarray(meta[k]) for k in _SCALARS})
        return out

    def has(self, name: str) -> bool:
        self.wait()
        return os.path.exists(self._path(name))


def apply_restore(state, restored: dict):
    """Rebuild a TrainState from a restored payload."""
    return state.replace(
        params=restored["params"], opt_state=restored["opt_state"],
        step=jnp.asarray(restored["step"], jnp.int32))
