"""The port's serving launcher end to end on the CPU.

``repro_torch.launch.serve.main`` at a smoke config with ``--device
cpu``: its generations file is read back by the JAX package's reader with
the tokens ``generate`` returned, and it is byte-identical to the file
``repro.core.ParallelWriter`` writes from the same tokens with the
reference's ``GEN_SCHEMA``.
"""

import os

import numpy as np
import pytest
import torch

import repro.core as R
from repro.launch.serve import GEN_SCHEMA as J_GEN_SCHEMA

from repro_torch.launch import serve

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))


def _serve(tmp_path, name="gen.rntj", seed=3, arch="smollm-360m"):
    out = str(tmp_path / name)
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "4", "--prompt-len", "12",
                      "--max-new", "6", "--seed", str(seed), "--out", out])
    return res, out


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma-2b", "rwkv6-7b",
                                  "zamba2-2.7b", "minicpm3-4b",
                                  "deepseek-moe-16b", "mixtral-8x22b",
                                  "chameleon-34b"])
def test_serve_writes_generations_the_reference_reads(tmp_path, arch):
    res, out = _serve(tmp_path, arch=arch)
    assert res.tokens.shape == (4, 6) and res.tokens.dtype == np.int32
    assert res.prompts.shape == (4, 12) and res.logits is None
    assert set(res.timings) == {"prefill_s", "decode_s", "write_s"}
    with R.RNTJReader(out) as r:
        assert r.n_entries == 4
        np.testing.assert_array_equal(r.read_column("request_id"), np.arange(4))
        np.testing.assert_array_equal(r.read_column("prompt_len"), [12] * 4)
        np.testing.assert_array_equal(r.read_column("tokens"), [6, 12, 18, 24])
        np.testing.assert_array_equal(
            r.read_column("tokens._0").reshape(4, 6), res.tokens)


def test_serve_codebooks_logs_the_first_stream(tmp_path):
    """musicgen-large: prompts (B, S, Q), generations (B, max_new, Q), the
    file holds codebook 0's stream, as the reference's launcher logs it."""
    res, out = _serve(tmp_path, arch="musicgen-large")
    q = res.cfg.n_codebooks
    assert q == 4 and res.prompts.shape == (4, 12, q)
    assert res.tokens.shape == (4, 6, q)
    with R.RNTJReader(out) as r:
        np.testing.assert_array_equal(r.read_column("tokens"), [6, 12, 18, 24])
        np.testing.assert_array_equal(
            r.read_column("tokens._0").reshape(4, 6), res.tokens[..., 0])


def test_serve_model_takes_a_cut_config(tmp_path):
    """``serve_model`` serves a config the caller made (a depth cut), as
    ``main`` serves the registry's."""
    from repro_torch.configs import smoke_config

    cfg = smoke_config("chameleon-34b").with_(n_layers=2)
    res = serve.serve_model(cfg, 2, 5, 3, 1, "cpu", str(tmp_path / "c.rntj"),
                            keep_logits=True)
    assert res.cfg.n_layers == 2 and res.tokens.shape == (2, 3)
    assert res.logits.shape == (2, 3, cfg.vocab_size)


def test_generation_file_is_byte_identical_to_reference_writer(tmp_path):
    res, out = _serve(tmp_path)
    gen, n = res.tokens, res.tokens.shape[0]
    ref_path = str(tmp_path / "ref.rntj")
    w = R.ParallelWriter(J_GEN_SCHEMA, ref_path)
    ctx = w.create_fill_context()
    ctx.fill_batch(R.ColumnBatch.from_arrays(J_GEN_SCHEMA, n, {
        "request_id": np.arange(n, dtype=np.int64),
        "prompt_len": np.full(n, 12, np.int32),
        "tokens": np.full(n, gen.shape[1], np.int64),
        "tokens._0": gen.reshape(-1).astype(np.int32),
    }))
    ctx.close()
    w.close()
    with open(out, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()


def test_serve_is_seeded(tmp_path):
    a, pa = _serve(tmp_path, "a.rntj", seed=3)
    b, pb = _serve(tmp_path, "b.rntj", seed=3)
    c, _ = _serve(tmp_path, "c.rntj", seed=4)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    with open(pa, "rb") as f1, open(pb, "rb") as f2:
        assert f1.read() == f2.read()
    assert not np.array_equal(a.prompts.numpy(), c.prompts.numpy())


def test_serve_keeps_the_logits_that_chose_each_token(tmp_path):
    res = serve.main(["--smoke", "--device", "cpu", "--requests", "2",
                      "--prompt-len", "5", "--max-new", "4", "--out",
                      str(tmp_path / "k.rntj")], keep_logits=True)
    assert res.logits.shape == (2, 4, res.cfg.vocab_size)
    np.testing.assert_array_equal(res.logits.float().argmax(-1).numpy(),
                                  res.tokens)
