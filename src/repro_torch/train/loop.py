"""Training loop: data -> step -> checkpoint, with restart & stragglers,
the twin of ``repro.train.loop`` on one card.

Fault-tolerance behaviour:
  * checkpoint every ``ckpt_every`` steps via the parallel single-file
    writer (async by default — the paper's opt-2 pattern: the loop blocks
    only on the snapshot hand-off, the copy of every leaf to the host);
  * checkpoints carry params, optimizer state AND the loader cursor, so a
    restarted run continues on the exact next batch;
  * on construction the loop restores the latest committed checkpoint if
    one exists (crash-restart is the default path, not a special case);
  * straggler mitigation: per-step wall time is tracked against a rolling
    median; a step slower than ``straggler_factor``x the median fires the
    ``on_straggler`` hook (at fleet scale: re-shard that host's data and
    deprioritize it; here the hook records the event and the test asserts
    the detection fires).

The step is ``make_train_step``'s eager step, built once (the
reference's ``jitted_for(shapes)`` has no counterpart), on one card
(``mesh=None``) or on a ``DeviceMesh`` (``launch.mesh``), where every rank
runs the loop on the same loader and keeps its shards of the state.  The
parameters, the optimizer state and the checkpoint manager live on
``device`` (``"cuda"`` by default, ``RuntimeError`` without a card;
``"cpu"`` when asked).  On a mesh the ranks gather the full state and
rank 0 saves it, in the one-card file format (the reference's one-host
semantics: its save gathers to the host); a restore is mesh-agnostic:
every rank reads the full leaves and keeps its shards on the current mesh
(``elastic.py``'s contract: placements come from (shape, mesh), never
from the file).  A restore puts every leaf on ``device``, in the order of
a freshly built state (the order sets the sums of the gradient norm, so a
resumed run repeats a straight one bit for bit); the loader's two leaves
come back to the host first.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.ckpt import CheckpointManager
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.registry import ModelBundle
from repro_torch.pipeline import PackedLoader

from repro_torch.distributed.sharding import place

from .optimizer import AdamW, AdamWState, make_optimizer, tree_map
from .step import init_train_state, make_train_step, param_sharding


@dataclass
class LoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_async: bool = True
    log_every: int = 10
    keep_ckpts: int = 3
    straggler_factor: float = 3.0
    grad_compression: bool = False
    microbatches: int = 1


@dataclass
class StepEvent:
    step: int
    loss: float
    wall_s: float
    straggler: bool = False


@dataclass
class SaveEvent:
    step: int
    #: the seconds the loop blocked in the save call: the host snapshot
    #: (async) or the whole save
    block_s: float


class TrainLoop:
    def __init__(
        self,
        bundle: ModelBundle,
        loader: PackedLoader,
        ckpt_dir: str,
        config: Optional[LoopConfig] = None,
        optimizer: Optional[AdamW] = None,
        on_straggler: Optional[Callable[[StepEvent], None]] = None,
        device="cuda",
        seed: int = 0,
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.bundle = bundle
        self.loader = loader
        self.config = config or LoopConfig()
        self.optimizer = optimizer or make_optimizer()
        self.mgr = CheckpointManager(ckpt_dir, keep=self.config.keep_ckpts,
                                     device=self.device)
        self.on_straggler = on_straggler
        self.history: List[StepEvent] = []
        self.saves: List[SaveEvent] = []
        #: the seconds the last ``run`` waited at its end for a save in flight
        self.wait_s = 0.0
        self._step_times: List[float] = []

        self._step_fn = make_train_step(
            bundle, optimizer=self.optimizer,
            grad_compression=self.config.grad_compression,
            microbatches=self.config.microbatches, mesh=mesh,
        )
        self.step = 0

        latest = self.mgr.latest_step()
        if latest is not None:
            self._restore(latest)
        else:
            self.params, self.opt_state, self.err_state = init_train_state(
                bundle, seed=seed, device=self.device,
                optimizer=self.optimizer,
                grad_compression=self.config.grad_compression, mesh=mesh,
            )

    # -- checkpoint integration ------------------------------------------------

    def _state_tree(self) -> Dict:
        ld = self.loader.state()  # device engine syncs its leftover here
        full = _full if self.mesh is not None else (lambda t: t)
        return {
            "params": tree_map(full, self.params),
            "opt": {"step": self.opt_state.step,
                    "m": tree_map(full, self.opt_state.m),
                    "v": tree_map(full, self.opt_state.v)},
            "err": tree_map(full, self.err_state),
            "loader": {
                "entry_cursor": np.asarray(ld["entry_cursor"]),
                "leftover": np.asarray(ld["leftover"], np.int32),
            },
        }

    def _save(self) -> None:
        tree = self._state_tree()  # on a mesh every rank gathers
        if self.mesh is not None and torch.distributed.get_rank() != 0:
            return
        meta = {"train_step": self.step}
        t0 = time.perf_counter()
        if self.config.ckpt_async:
            self.mgr.save_async(self.step, tree, meta)
        else:
            self.mgr.save(self.step, tree, meta)
        self.saves.append(SaveEvent(self.step, time.perf_counter() - t0))

    def _template(self) -> Dict:
        """The state tree's structure with shape-only leaves: a restore
        rebuilds in its dict order (a fresh state's), not the sorted order
        of the file's names."""
        shapes = self.bundle.init(None, "meta")
        err = (shapes if self.config.grad_compression
               else torch.empty((), device="meta"))
        return {"params": shapes, "opt": {"step": 0, "m": shapes, "v": shapes},
                "err": err, "loader": {"entry_cursor": 0, "leftover": 0}}

    def _restore(self, step: int) -> None:
        tree, meta = self.mgr.restore(step, target_tree=self._template())
        self.params = tree["params"]
        o = tree["opt"]
        self.opt_state = AdamWState(o["step"], o["m"], o["v"])
        self.err_state = tree["err"]
        if self.mesh is not None:
            sh = param_sharding(self.bundle, self.mesh)
            self.params = tree_map(place, self.params, sh)
            self.opt_state = AdamWState(o["step"],
                                        tree_map(place, o["m"], sh),
                                        tree_map(place, o["v"], sh))
            if self.config.grad_compression:
                self.err_state = tree_map(place, self.err_state, sh)
        ld = tree["loader"]
        self.loader.load_state({
            "entry_cursor": int(ld["entry_cursor"].cpu()),
            "leftover": ld["leftover"].cpu().numpy().astype(np.int32),
        })
        self.step = int(meta["train_step"])

    # -- run ----------------------------------------------------------------

    def run(self, steps: Optional[int] = None) -> List[StepEvent]:
        steps = steps if steps is not None else self.config.steps
        batches = self.loader.batches()
        target = self.step + steps
        while self.step < target:
            with obs.span("train.step"):
                self._one_step(batches)

        t0 = time.perf_counter()
        self.mgr.wait()
        if self.mesh is not None:
            torch.distributed.barrier()  # rank 0's save is committed
        self.wait_s = time.perf_counter() - t0
        return self.history

    def _one_step(self, batches) -> None:
        with obs.span("train.loader_next"):
            batch = next(batches)
        t0 = time.perf_counter()
        self.params, self.opt_state, self.err_state, metrics = self._step_fn(
            self.params, self.opt_state, self.err_state, batch)
        loss = float(metrics["loss"])
        wall = time.perf_counter() - t0
        self.step += 1

        straggler = False
        if len(self._step_times) >= 5:
            med = float(np.median(self._step_times[-20:]))
            straggler = wall > self.config.straggler_factor * med
        self._step_times.append(wall)
        ev = StepEvent(self.step, loss, wall, straggler)
        self.history.append(ev)
        if straggler and self.on_straggler:
            self.on_straggler(ev)
        if self.step % self.config.log_every == 0:
            print(f"step {self.step:6d}  loss {loss:8.4f}  {wall*1e3:8.1f} ms",
                  flush=True)
        if self.step % self.config.ckpt_every == 0:
            self._save()


def _full(t):
    """A DTensor leaf gathered whole (every rank takes part)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t
