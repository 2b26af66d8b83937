"""The frozen arithmetic and corpus against values worked out by hand."""

import hashlib
import json

import pytest

from smoke_cells import CHECKOUT

from portbench.yardstick import flops
from portbench.yardstick.corpus import synth_corpus


def cfg(name):
    return json.loads((CHECKOUT / "portbench" / "configs" / f"{name}.json").read_text())


PAIRS_4096 = 4096 * 4097 // 2  # causal (query, key) pairs at 4,096
# chameleon-34b's block: attention 2 x 8192 x 8192 + 2 x 8192 x 1024, two
# norms, qk-norm gains 2 x 128, SwiGLU 3 x 8192 x 22016
LAYER = 2 * 8192 * 8192 + 2 * 8192 * 1024 + 2 * 8192 + 2 * 128 + 3 * 8192 * 22016
HEAD = 8192 * 65536


@pytest.mark.parametrize("name,layers,count", [
    ("chameleon-34b", 4, 3_842_057_216),
    ("chameleon-34b-serve", 16, 12_146_978_816)])
def test_parameter_counts(name, layers, count):
    assert LAYER == 692_076_800
    assert flops.param_count(cfg(name)) == layers * LAYER + 2 * HEAD + 8192 == count
    assert flops.active_params(cfg(name)) == layers * LAYER + HEAD + 8192


def test_train_step_flops_at_the_published_context():
    n = 4 * LAYER + HEAD + 8192
    assert n == 3_305_186_304
    attention = 2 * 2 * 64 * (128 + 128) * PAIRS_4096 * 4
    assert flops.train_step_flops(cfg("chameleon-34b"), 2, 4096) == (
        6 * n * 2 * 4096 + 3 * attention)


def test_causal_pairs_by_hand():
    assert flops.causal_pairs(4, 4) == 10
    assert flops.causal_pairs(2, 4) == 7      # queries at positions 2 and 3
    assert flops.causal_pairs(4096, 4096) == PAIRS_4096


def test_attention_bounds_at_the_train_cell():
    # K5 at (2, 64, 8, 4096, 4096, 128): operations bound both ways
    ms, by = flops.attention_fwd_bound((2, 64, 8, 4096, 4096, 128), 2)
    assert by == "operations"
    assert ms == pytest.approx(2 * 2 * 64 * 256 * PAIRS_4096 / 989e12 * 1e3)
    assert ms == pytest.approx(0.55601, abs=1e-5)
    ms, by = flops.attention_bwd_bound((2, 64, 8, 4096, 4096, 128), 2)
    assert by == "operations"
    assert ms == pytest.approx(2 * 2 * 64 * PAIRS_4096 * 640 / 989e12 * 1e3)


def test_frozen_corpus_is_the_generator_it_copies():
    """The documents of ``src/repro_torch/pipeline/ingest.py:24``'s
    generator at these arguments, as they were when it was frozen."""
    docs = synth_corpus(50, seed=0, mean_len=64, vocab=1000)
    blob = b"".join(d.tobytes() for _, d in docs)
    assert sum(len(d) for _, d in docs) == 3583
    assert hashlib.sha256(blob).hexdigest() == (
        "5010b83396e1be2398dc2b3e2632079d6dcc7fe49514e11a156fbadcc7db4a18")


def test_serving_arithmetic_at_the_serve_cell():
    layers = 16 * LAYER
    pairs = 1040 * 1041 // 2
    prefill = (2 * layers * 16 * 1040 + 2 * 16 * 64 * 256 * pairs * 16
               + 2 * HEAD * 16)
    decode = sum(2 * (layers + HEAD) * 16 + 4 * 16 * 64 * 128 * (1040 + i + 1) * 16
                 for i in range(31))
    assert flops.serve_batch_flops(cfg("chameleon-34b-serve"), 16, 1040, 32) == (
        pytest.approx(prefill + decode, rel=1e-12))
    # K6 at (16, 64, 8, 128), 1,064 rows: bytes bound
    ms, by = flops.decode_attention_bound((16, 64, 8, 128), 1064, 2)
    assert by == "bytes"
    assert ms == pytest.approx(2 * (2 * 16 * 8 * 1064 * 128 + 2 * 16 * 64 * 128)
                               / 3.35e12 * 1e3)
    # K5 at a 1,040-token prefill of 16: operations bound
    ms, by = flops.attention_fwd_bound((16, 64, 8, 1040, 1040, 128), 2)
    assert by == "operations"
    assert ms == pytest.approx(2 * 16 * 64 * 256 * pairs / 989e12 * 1e3)
