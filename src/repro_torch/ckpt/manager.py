"""Checkpoint manager: atomic commits, rotation, async saves, restart.

Fault-tolerance contract:
  * a checkpoint only becomes visible via atomic ``os.rename`` of the
    finished file — a crash mid-write leaves a ``.tmp`` that restart
    ignores and garbage-collects;
  * every rename/unlink is followed by an fsync of the *directory*: the
    commit is durable only once the directory entry is on disk, and a
    prune is final only once the unlink is (otherwise a power cut can
    resurrect a pruned step or lose a committed one);
  * ``latest_step``/``restore`` always pick the newest *committed* step;
  * ``save_async`` runs the parallel writer on a background thread (the
    paper's opt-2 applies: the training loop only blocks on the metadata
    hand-off, i.e. the host-copy snapshot, taken before ``save_async``
    returns, so the step may overwrite the tensors at once);
    ``restore``/``steps`` first
    synchronize with any in-flight async save so they never race the
    rename/prune it performs;
  * ``processes > 0`` routes saves through the multi-process writer
    (DESIGN.md §8.6): N real processes share one container file.  A
    degraded seal (a worker died mid-save) is *not* committed unless
    ``allow_degraded=True`` — a salvaged checkpoint is only ever visible
    by explicit opt-in, and restores from it need ``strict=False``.

``device`` (default ``"cuda"``) is where the writers run and where
``restore`` puts the leaves; without a card and without ``device="cpu"``
the manager refuses to start.
"""

from __future__ import annotations

import json
import os
import re
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device

from .checkpoint import (
    _flatten_with_names, load_checkpoint, save_checkpoint, save_checkpoint_mp,
)

_STEP_RE = re.compile(r"^step_(\d+)\.rntj$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, n_writers: int = 4,
                 processes: int = 0, allow_degraded: bool = False,
                 mp_options=None, device="cuda"):
        self.device = resolve_device(device)
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.n_writers = n_writers
        self.processes = processes
        self.allow_degraded = allow_degraded
        self.mp_options = mp_options
        self._async_thread: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None
        self.gc_tmp()

    # -- paths ---------------------------------------------------------------

    def path_for(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}.rntj"

    def steps(self) -> List[int]:
        self.wait()  # an in-flight async save may be mid-rename/prune
        out = []
        for f in self.dir.iterdir():
            m = _STEP_RE.match(f.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def gc_tmp(self) -> None:
        removed = False
        for pat in ("*.tmp", "*.tmp.mpwlog"):
            for f in self.dir.glob(pat):
                f.unlink()  # crash leftovers: never committed, safe to drop
                removed = True
        if removed:
            self._fsync_dir()

    def _fsync_dir(self) -> None:
        """Make the directory's own entries durable.  ``os.replace`` and
        ``unlink`` mutate the directory, not the file — without this a
        crash after "commit" can roll the directory back to a state where
        the rename (or the prune) never happened."""
        fd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree, metadata: Optional[Dict] = None) -> Dict:
        tmp = self.dir / f"step_{step:010d}.rntj.tmp"
        meta = {"step": step, **(metadata or {})}
        if self.processes:
            stats = save_checkpoint_mp(
                str(tmp), tree, n_processes=self.processes,
                options=self.mp_options, metadata=meta, device=self.device)
            # degraded seal keeps its side-car for forensics; the tmp is
            # either committed (self-contained, footer valid) or dropped,
            # so the log must not outlive this decision
            Path(str(tmp) + ".mpwlog").unlink(missing_ok=True)
            if stats.get("degraded") and not self.allow_degraded:
                tmp.unlink(missing_ok=True)
                raise IOError(
                    f"step {step}: degraded multi-process save "
                    f"(report: {stats}); refusing to commit — pass "
                    f"allow_degraded=True to keep salvaged checkpoints")
        else:
            stats = save_checkpoint(str(tmp), tree, n_writers=self.n_writers,
                                    metadata=meta, device=self.device)
        os.replace(tmp, self.path_for(step))  # atomic commit
        self._fsync_dir()  # rename is durable only once the dir entry is
        self._prune()
        return stats

    def save_async(self, step: int, tree, metadata: Optional[Dict] = None) -> None:
        """Snapshot now (host copies), write in the background."""
        self.wait()
        leaves, rebuild = _flatten_with_names(tree)
        snapshot = rebuild([
            x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
            else np.array(x, copy=True) for _, x in leaves])

        def run():
            try:
                self.save(step, snapshot, metadata)
            except BaseException as e:  # surfaced on next wait()
                self._async_error = e

        self._async_thread = threading.Thread(target=run, daemon=True)
        self._async_thread.start()

    def wait(self) -> None:
        t = self._async_thread
        if t is not None:
            if t is threading.current_thread():
                # save() -> _prune() -> steps() runs ON the async thread;
                # joining ourselves would deadlock, and there is nothing
                # to wait for — the save in flight is this very call
                return
            t.join()
            self._async_thread = None
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            raise err

    def _prune(self) -> None:
        steps = self.steps()
        removed = False
        for s in steps[: -self.keep]:
            self.path_for(s).unlink()
            removed = True
        if removed:
            self._fsync_dir()  # a pruned step must not resurrect after a crash

    # -- restore ---------------------------------------------------------------

    def restore(self, step: Optional[int] = None, target_tree=None,
                strict: bool = True):
        """-> (tree, metadata) of ``step`` (the newest committed one by
        default), its leaves on the manager's device."""
        self.wait()  # never read behind an in-flight async save's rename
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        tree, meta = load_checkpoint(str(self.path_for(step)),
                                     target_tree=target_tree,
                                     device=self.device,
                                     strict=strict)
        return tree, meta
