"""Faults planted underneath the timed path, for the CPU tests and the
calibration; the benchmark's own runs never plant one.

Each is a context manager that patches the program's classes and entries
that the drivers look up when they build a run, so that the drivers run
unchanged on a broken program:

* training (``TRAIN``): ``unchanged``, a step that returns its state
  unchanged; ``half_batch``, half of each batch left out and the mean
  taken over the rest; ``token``, a token of the first batch altered as
  the loader produces it;
* serving (``SERVE``): ``token``, the first decode step's token of the
  batch's first request altered where it is produced; ``half_batch``,
  half of each batch never answered.
"""

from __future__ import annotations

import contextlib

TRAIN = ("unchanged", "half_batch", "token")
SERVE = ("token", "half_batch")


@contextlib.contextmanager
def _patched(owner, name, value):
    real = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield real
    finally:
        setattr(owner, name, real)


def _train_loop(fault: str):
    import repro_torch.train as T

    real = T.TrainLoop

    class Loop(real):
        def __init__(self, bundle, *a, **k):
            super().__init__(bundle, *a, **k)
            step = self._step_fn
            if fault == "half_batch":
                def broken(p, o, e, b):
                    return step(p, o, e, {key: v[: v.shape[0] // 2]
                                          for key, v in b.items()})
            else:
                def broken(p, o, e, b):
                    import torch

                    from repro_torch.train.step import to_device
                    with torch.no_grad():
                        loss, _ = bundle.loss(p, to_device(b, self.device))
                    return p, o, e, {"loss": loss}
            self._step_fn = broken

    return _patched(T, "TrainLoop", Loop)


def _train_loader():
    import repro_torch.pipeline as P

    real = P.PackedLoader

    class Loader(real):
        def batches(self):
            first = True
            for b in super().batches():
                if first:
                    b = {k: v.clone() for k, v in b.items()}
                    b["tokens"][0, 0] = (b["tokens"][0, 0] + 1) % 7
                    first = False
                yield b

    return _patched(P, "PackedLoader", Loader)


@contextlib.contextmanager
def _serve_token():
    from repro_torch.models.registry import ModelBundle

    steps = [0]
    prefill, decode = ModelBundle.prefill, ModelBundle.decode_step

    def counted(self, *a, **k):
        steps[0] = 0
        return prefill(self, *a, **k)

    def altered(self, *a, **k):
        logits, cache = decode(self, *a, **k)
        steps[0] += 1
        if steps[0] == 1:
            logits = logits.clone()
            best = int(logits[0, -1].argmax())
            logits[0, -1, (best + 1) % logits.shape[-1]] = logits[0, -1, best] + 1e4
        return logits, cache

    with _patched(ModelBundle, "prefill", counted), \
            _patched(ModelBundle, "decode_step", altered):
        yield


def _serve_half():
    import repro_torch.launch.serve as S

    real = S.generate

    def half(bundle, params, prompts, *a, **k):
        return real(bundle, params, prompts, *a, **k)[: prompts.shape[0] // 2]

    return _patched(S, "generate", half)


def planted(kind: str, fault: str):
    """The context in which a ``kind`` (``train`` or ``serve``) run has
    ``fault``."""
    if kind == "train" and fault in ("unchanged", "half_batch"):
        return _train_loop(fault)
    if kind == "train" and fault == "token":
        return _train_loader()
    if kind == "serve" and fault == "token":
        return _serve_token()
    if kind == "serve" and fault == "half_batch":
        return _serve_half()
    raise ValueError(f"no fault {fault!r} for {kind}")
