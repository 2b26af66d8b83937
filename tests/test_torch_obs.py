"""The port's spans and counters (``repro_torch.obs``), on the CPU.

* With recording off a span records nothing and opens no profiler range.
* Under ``obs.recording()`` and under a CPU ``torch.profiler`` the
  counts, host times, parents and ``summary()`` are right, a span on a
  second thread records under a profiler the main thread started, and the
  kept spans are bounded, the oldest going first.
* ``TrainLoop.run(3)`` records three steps with their loader, forward and
  backward, and optimizer spans inside; ``generate`` one prefill and
  ``max_new - 1`` decode steps under one ``serve.generate``; the parallel
  writer a fill and a close span; ``serve_model``'s timings come from the
  spans.
* The launch counter, folded into ``obs``, returns what it returned before.
"""

import os
import sys
import threading
import time
from collections import Counter, deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import smoke_config
from repro_torch.core import (ColumnBatch, ParallelWriter, SequentialWriter)
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import build
from repro_torch.pipeline import PackedLoader, ingest_corpus, synth_corpus
from repro_torch.train import LoopConfig, TrainLoop, make_optimizer

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh():
    obs.reset()
    yield
    obs.reset()


def _counts(summary):
    return {name: e["count"] for name, e in summary.items()}


def test_recording_off_records_nothing_and_opens_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range for {name} with recording off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    # card=True makes no CUDA event either: there is no card here
    with obs.span("a"), obs.span("b", card=True):
        pass
    assert not obs._spans and obs.summary() == {}


def test_recording_counts_host_times_and_parents():
    with obs.recording():
        t0 = time.perf_counter_ns()
        with obs.span("outer"):
            for _ in range(2):
                with obs.span("inner"):
                    time.sleep(0.002)
        wall = (time.perf_counter_ns() - t0) / 1e6
        with obs.span("top"):
            pass
    with obs.span("after"):   # recording is off again
        pass
    got = list(obs._spans)
    assert [x.name for x in got] == ["inner", "inner", "outer", "top"]
    assert [x.parent for x in got] == ["outer", "outer", None, None]
    s = obs.summary()
    assert _counts(s) == {"inner": 2, "outer": 1, "top": 1}
    assert s["inner"]["parent"] == "outer" and s["outer"]["parent"] is None
    assert s["outer"]["card_ms"] is None and s["inner"]["card_ms"] is None
    assert s["inner"]["host_ms"] == pytest.approx(got[0].host_ms
                                                  + got[1].host_ms)
    assert s["inner"]["host_ms"] >= 4.0
    assert s["inner"]["host_ms"] <= s["outer"]["host_ms"] <= wall


def test_summary_since_a_mark():
    with obs.recording():
        with obs.span("before"):
            pass
        since = obs.mark()
        with obs.span("after"):
            pass
    assert set(obs.summary()) == {"before", "after"}
    assert set(obs.summary(since)) == {"after"}


def test_a_profiler_turns_recording_on_for_every_thread():
    def other():
        with obs.span("thread.span"):
            pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("main.span"):
            torch.ones(4).sum()
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    with obs.span("off"):
        pass
    s = obs.summary()
    assert _counts(s) == {"main.span": 1, "thread.span": 1}
    # the second thread's span is not nested in the first thread's
    assert s["thread.span"]["parent"] is None
    # the span is a range on the profiler's clock
    assert "main.span" in {e.name for e in prof.events()}


def test_kept_spans_are_bounded_oldest_first(monkeypatch):
    monkeypatch.setattr(obs, "_spans", deque(maxlen=3))
    with obs.recording():
        for i in range(5):
            with obs.span(f"s{i}"):
                pass
    assert [s.name for s in obs._spans] == ["s2", "s3", "s4"]
    assert _counts(obs.summary()) == {"s2": 1, "s3": 1, "s4": 1}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("data") / "c.rntj")
    ingest_corpus(synth_corpus(120, seed=0, mean_len=60, vocab=512), p,
                  n_workers=2, device=CPU)
    return p


def test_train_loop_records_its_phases(corpus, tmp_path):
    loop = TrainLoop(
        build(smoke_config("smollm-360m")),
        PackedLoader(corpus, batch=2, seq_len=32, device=CPU),
        str(tmp_path / "ckpt"),
        config=LoopConfig(steps=3, ckpt_every=1000, log_every=1000,
                          ckpt_async=False),
        optimizer=make_optimizer(peak_lr=1e-3, warmup=2, total=10),
        device=CPU)
    loop.run(1)                 # recording off: nothing kept
    assert obs.summary() == {}
    with obs.recording():
        loop.run(3)
    s = obs.summary()
    assert _counts(s) == {"train.step": 3, "train.loader_next": 3,
                          "train.forward_backward": 3, "train.optimizer": 3}
    assert s["train.step"]["parent"] is None
    for phase in ("train.loader_next", "train.forward_backward",
                  "train.optimizer"):
        assert s[phase]["parent"] == "train.step"
    # each step holds one of each of its phases, in order
    assert [x.name for x in obs._spans][:4] == [
        "train.loader_next", "train.forward_backward", "train.optimizer",
        "train.step"]
    assert s["train.optimizer"]["card_ms"] is None    # the CPU: host only
    assert s["train.step"]["host_ms"] >= (s["train.forward_backward"]["host_ms"]
                                          + s["train.optimizer"]["host_ms"])


@pytest.mark.parametrize("max_new", [1, 4])
def test_generate_records_prefill_and_decode_under_one_batch(max_new):
    cfg = smoke_config("smollm-360m")
    bundle = build(cfg)
    g = torch.Generator().manual_seed(0)
    params = bundle.init(g, CPU)
    prompts = torch.randint(0, cfg.vocab_size, (2, 5), dtype=torch.int32)
    with obs.recording():
        gen = serve.generate(bundle, params, prompts, max_new)
        since = obs.mark()
        serve.generate(bundle, params, prompts, 2)
    assert gen.shape == (2, max_new)
    first = obs.summary()
    second = obs.summary(since)
    assert _counts(second) == {"serve.generate": 1, "serve.prefill": 1,
                               "serve.decode_step": 1}
    # Counters: a missing name counts zero
    assert Counter(_counts(first)) - Counter(_counts(second)) == Counter(
        {"serve.generate": 1, "serve.prefill": 1,
         "serve.decode_step": max_new - 1})
    assert first["serve.generate"]["parent"] is None
    assert first["serve.prefill"]["parent"] == "serve.generate"
    assert second["serve.decode_step"]["parent"] == "serve.generate"


@pytest.mark.parametrize("kind", ["parallel", "sequential"])
def test_writers_record_a_fill_and_a_close(tmp_path, kind):
    """The parallel writer, the serving path's, records its fills and
    closes; the sequential writer has no spans."""
    schema = serve.GEN_SCHEMA
    batch = ColumnBatch.from_arrays(schema, 3, {
        "request_id": np.arange(3, dtype=np.int64),
        "prompt_len": np.full(3, 4, np.int32),
        "tokens": np.full(3, 2, np.int64),
        "tokens._0": np.arange(6, dtype=np.int32)})
    path = str(tmp_path / "g.rntj")
    with obs.recording():
        if kind == "parallel":
            w = ParallelWriter(schema, path, device=CPU)
            ctx = w.create_fill_context()
            ctx.fill_batch(batch)
            ctx.fill_batch(batch)
            ctx.close()
            w.close()
            want = {"writer.fill_batch": 2, "writer.close": 2}
        else:
            w = SequentialWriter(schema, path, device=CPU)
            w.fill_batch(batch)
            w.fill_batch(batch)
            w.close()
            want = {}
    s = obs.summary()
    assert _counts(s) == want
    stats = w.stats.as_dict()
    assert stats["entries"] == 6
    if want:
        # the fill spans bracket the writer's own fill clock
        assert 0 < stats["fill_ms"] <= s["writer.fill_batch"]["host_ms"]


def test_a_parallel_writer_drains_an_open_context_in_one_close(tmp_path):
    schema = serve.GEN_SCHEMA
    w = ParallelWriter(schema, str(tmp_path / "g.rntj"), device=CPU)
    ctx = w.create_fill_context()
    ctx.fill_batch(ColumnBatch.from_arrays(schema, 1, {
        "request_id": np.zeros(1, np.int64), "prompt_len": np.ones(1, np.int32),
        "tokens": np.ones(1, np.int64), "tokens._0": np.ones(1, np.int32)}))
    with obs.recording():
        w.close()
    assert _counts(obs.summary()) == {"writer.close": 1}  # none nested


def test_serve_model_timings_come_from_the_spans(tmp_path):
    res = serve.serve_model(smoke_config("smollm-360m"), 2, 5, 3, 0, "cpu",
                            str(tmp_path / "g.rntj"))
    s = obs.summary()
    assert s["serve.decode_step"]["count"] == 2
    assert res.timings == serve.span_seconds(s)
    assert set(res.timings) == {"prefill_s", "decode_s", "write_s"}
    assert all(v > 0 for v in res.timings.values())
    # wall seconds: the prefill and the decode make up the whole batch
    assert res.timings["prefill_s"] == pytest.approx(
        s["serve.prefill"]["host_ms"] / 1e3)
    assert res.timings["prefill_s"] + res.timings["decode_s"] == \
        pytest.approx(s["serve.generate"]["host_ms"] / 1e3)
    assert res.timings["decode_s"] >= s["serve.decode_step"]["host_ms"] / 1e3
    assert res.timings["write_s"] == pytest.approx(
        (s["writer.fill_batch"]["host_ms"] + s["writer.close"]["host_ms"]) / 1e3)


def test_span_seconds_prefers_card_time():
    """On the card the prefill ends when its work does (the span's card
    time), not when its launches return; the decode is the rest of the
    batch's wall time."""
    s = {"serve.generate": {"count": 1, "host_ms": 1000.0, "card_ms": None,
                            "parent": None},
         "serve.prefill": {"count": 1, "host_ms": 5.0, "card_ms": 700.0,
                           "parent": "serve.generate"},
         "serve.decode_step": {"count": 7, "host_ms": 70.0, "card_ms": 280.0,
                               "parent": "serve.generate"},
         "writer.fill_batch": {"count": 1, "host_ms": 0.5, "card_ms": None,
                               "parent": None}}
    assert serve.span_seconds(s) == pytest.approx(
        {"prefill_s": 0.7, "decode_s": 0.3, "write_s": 0.0005})


def test_the_launch_counter_returns_what_it_did_before_the_fold():
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert ops.launch_shapes() == {k: Counter() for k in ops.KERNELS}
    ops.count_launch("offsets_scan", (10,))
    ops.count_launch("offsets_scan", [10])
    ops.count_launch("flash_attention", (1, 2, 2, 8, 8, 16))
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(offsets_scan=2, flash_attention=1)
    assert ops.launch_counts() == want
    assert list(ops.launch_counts()) == list(ops.KERNELS)
    shapes = ops.launch_shapes()
    assert shapes["offsets_scan"] == Counter({(10,): 2})
    assert shapes["flash_attention"] == Counter({(1, 2, 2, 8, 8, 16): 1})
    assert shapes["decode_attention"] == Counter()
    # copies: the caller's dicts do not alias the registry
    shapes["offsets_scan"][(10,)] = 99
    assert ops.launch_shapes()["offsets_scan"][(10,)] == 2
    # one registry: the counts are obs's
    assert obs.launch_counts() == want
    with pytest.raises(KeyError):
        ops.count_launch("no_such_kernel", (1,))
    assert "no_such_kernel" not in ops.launch_counts()
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert obs.launch_shapes() == {k: Counter() for k in ops.KERNELS}


def test_the_launch_counter_loses_no_count_across_threads():
    ops.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(500):
                ops.count_launch("byteshuffle_pages", (i % 3,))

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert ops.launch_counts()["byteshuffle_pages"] == 16 * 500
    assert sum(ops.launch_shapes()["byteshuffle_pages"].values()) == 16 * 500
    ops.reset_launch_counts()
