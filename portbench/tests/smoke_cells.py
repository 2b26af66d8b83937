"""Smoke-sized cells for the CPU tests: the benchmark's layout in a
temporary root, with two tiny configurations of the real cells' kinds
(dense with qk-norm, MoE with shared experts) and a short traffic mix.

Their limits are set at this size from readings on the CPU over eight
seeds, the program's bf16 against the fp32 reference and the float8
control against it: dense, the program's gradient gap at most 0.0020 and
the control's at least 0.0068 (loss and change gaps overlap); MoE, where
capacity drops flip at this size, the program's (loss, gradient, change)
gaps up to (0.026, 0.019, 0.0065) and the control's from (0.016, 0.018,
0.0075), so that only seed 5 (and one writer thread, which fixes the
file's order) is used for the control there: program (0.0070, 0.0187,
0.0033), control (0.0159, 0.0490, 0.0095); the whole first gradient's
difference (``grad_diff``) separates there on every seed: the program
0.035-0.19, the control 0.38-0.52.  Every planted fault reads 0.05 or
more.
"""

import json
import shutil
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
for p in (CHECKOUT / "src", CHECKOUT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

LIMITS = {
    "tiny-dense": {"loader_tokens_wrong": 0, "loss_gap": 0.01,
                   "grad_gap": 0.004, "change_gap": 0.003},
    "tiny-moe": {"loader_tokens_wrong": 0, "loss_gap": 0.03,
                 "grad_gap": 0.03, "change_gap": 0.007, "grad_diff": 0.3},
}

SERVE_LIMITS = {"answers_missing": 0, "log_tokens_wrong": 0,
                "served_logit_gap": 0.05}

DENSE = {"name": "tiny-dense", "source": "smoke", "family": "vlm",
         "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 512, "qk_norm": True,
         "norm_eps": 1e-5, "rope_theta": 10000.0, "param_dtype": "float32",
         "compute_dtype": "bfloat16", "reduced": []}
MOE = {"name": "tiny-moe", "source": "smoke", "family": "moe", "n_layers": 2,
       "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
       "d_ff": 32, "vocab_size": 512,
       "moe": {"n_experts": 8, "top_k": 2, "n_shared": 1,
               "capacity_factor": 1.25, "norm_topk_prob": True,
               "aux_loss_alpha": 0.01},
       "norm_eps": 1e-6, "rope_theta": 10000.0, "param_dtype": "float32",
       "compute_dtype": "bfloat16", "reduced": []}


def make_root(tmp: Path, head_dim: int = 16) -> Path:
    """A benchmark root under ``tmp``: the real metrics, the smoke cells
    (at ``head_dim`` 64 for the card, whose K5 takes no head dim 16)."""
    root = Path(tmp) / "bench"
    for d in ("configs", "traffic", "workloads"):
        (root / d).mkdir(parents=True)
    shutil.copytree(CHECKOUT / "portbench" / "metrics", root / "metrics")
    traffic = json.loads((CHECKOUT / "portbench" / "traffic" / "pretrain-4k.json").read_text())
    traffic.update(name="tiny-train", batch=4, seq_len=64, corpus_docs=200,
                   mean_len=64, trace_steps=1, writer_threads=1)
    (root / "traffic" / "tiny-train.json").write_text(json.dumps(traffic))
    serve = json.loads((CHECKOUT / "portbench" / "traffic" / "image-to-text.json").read_text())
    serve.update(name="tiny-serve", batch=4, image_tokens=16, image_codes=64,
                 tasks=[{"name": "caption", "images": 1, "text": [4, 8],
                         "max_new": 6, "batches": 2},
                        {"name": "question", "images": 1, "text": [4, 12],
                         "max_new": 3, "batches": 2},
                        {"name": "text", "images": 0, "text": [8, 24],
                         "max_new": 4, "batches": 1}],
                 checked_requests=3, trace_batches=1)
    (root / "traffic" / "tiny-serve.json").write_text(json.dumps(serve))
    cell = {"name": "tiny-dense.serve", "config": "tiny-dense",
            "traffic": "tiny-serve", "chips": 1, "why": "smoke",
            "limits": SERVE_LIMITS}
    (root / "workloads" / "tiny-dense.serve.json").write_text(json.dumps(cell))
    for cfg in (DENSE, MOE):
        cfg = dict(cfg, head_dim=head_dim, d_model=4 * head_dim)
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        cell = {"name": f"{cfg['name']}.train", "config": cfg["name"],
                "traffic": "tiny-train", "chips": 1, "why": "smoke",
                "limits": LIMITS[cfg["name"]]}
        (root / "workloads" / f"{cell['name']}.json").write_text(json.dumps(cell))
    return root
