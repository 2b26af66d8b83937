"""The readers of the program's own spans (``repro_torch.obs``): each on a
hand-filled registry, None off its driver, without a trace, and with a
program that has no spans."""

import sys

import pytest

from smoke_cells import CHECKOUT  # noqa: F401  (puts src on the path)

from portbench import spec

SUMMARY = {
    "train.step": {"count": 4, "host_ms": 2800.0, "card_ms": None,
                   "parent": None},
    "train.loader_next": {"count": 4, "host_ms": 1.6, "card_ms": None,
                          "parent": "train.step"},
    "train.forward_backward": {"count": 4, "host_ms": 900.0,
                               "card_ms": 1880.0, "parent": "train.step"},
    "train.optimizer": {"count": 4, "host_ms": 60.0, "card_ms": 840.0,
                        "parent": "train.step"},
    "serve.generate": {"count": 3, "host_ms": 4000.0, "card_ms": None,
                       "parent": None},
    "serve.prefill": {"count": 3, "host_ms": 2100.0, "card_ms": 2130.0,
                      "parent": "serve.generate"},
    "serve.decode_step": {"count": 50, "host_ms": 400.0, "card_ms": 1750.0,
                          "parent": "serve.generate"},
    "writer.fill_batch": {"count": 3, "host_ms": 1.2, "card_ms": None,
                          "parent": None},
    "writer.close": {"count": 2, "host_ms": 0.6, "card_ms": None,
                     "parent": None},
}

WANT = {
    "optimizer_card_ms.train": ("train", 840.0 / 4),
    "fwd_bwd_card_ms.train": ("train", 1880.0 / 4),
    "prefill_card_ms.serve": ("serve", 2130.0 / 3),
}


@pytest.fixture
def readers():
    got = spec.metric_readers()
    return {name: got[name] for name in WANT}


@pytest.fixture
def registry(monkeypatch):
    from repro_torch import obs

    def filled(since=0):
        return {k: dict(v) for k, v in SUMMARY.items()}

    monkeypatch.setattr(obs, "summary", filled)
    return obs


def _ctx(driver, trace=True):
    return {"driver": driver, "trace": {"window_s": 1.0, "busy_s": 0.9}
            if trace else None}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_hand_filled_registry(readers, registry, name):
    driver, value = WANT[name]
    reader = readers[name]
    assert reader.UNIT == "ms"
    assert reader.read(_ctx(driver)) == pytest.approx(value)
    other = "serve" if driver == "train" else "train"
    assert reader.read(_ctx(other)) is None
    assert reader.read(_ctx(driver, trace=False)) is None
    assert reader.read({"driver": driver, "trace": {}}) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_in_an_empty_registry(readers, monkeypatch, name):
    from repro_torch import obs

    monkeypatch.setattr(obs, "summary", lambda since=0: {})
    assert readers[name].read(_ctx(WANT[name][0])) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_of_a_program_without_spans_returns_none(readers, monkeypatch,
                                                        name):
    import repro_torch

    monkeypatch.delattr(repro_torch, "obs", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)   # ImportError
    assert readers[name].read(_ctx(WANT[name][0])) is None


def test_card_metrics_need_card_time(readers, registry, monkeypatch):
    """A registry filled on the CPU (no CUDA events) gives no card
    metric."""
    def host_only(since=0):
        return {k: dict(v, card_ms=None) for k, v in SUMMARY.items()}

    monkeypatch.setattr(registry, "summary", host_only)
    for name, (driver, _) in WANT.items():
        assert readers[name].read(_ctx(driver)) is None, name


def test_a_real_registry_reads_its_spans(readers):
    """Spans recorded by the program under ``obs.recording()`` feed the
    readers through ``obs.summary()`` (card times set by hand: the CPU
    records no CUDA event)."""
    from repro_torch import obs

    obs.reset()
    try:
        with obs.recording():
            for _ in range(2):
                with obs.span("serve.generate"):
                    with obs.span("serve.prefill"):
                        pass
                    with obs.span("serve.decode_step"):
                        pass
        for i, x in enumerate(obs._spans):
            if x.name == "serve.prefill":
                x.card_ms = 100.0 * (i + 1)
        want = sum(x.card_ms for x in obs._spans
                   if x.name == "serve.prefill") / 2
        got = readers["prefill_card_ms.serve"].read(_ctx("serve"))
        assert got == pytest.approx(want)
        assert readers["optimizer_card_ms.train"].read(_ctx("train")) is None
    finally:
        obs.reset()
