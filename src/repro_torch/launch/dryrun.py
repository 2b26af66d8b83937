"""Multi-pod dry-run on the ``meta`` device: every (arch x shape x mesh)
cell's per-rank cost, with nothing allocated.  The twin of
``repro.launch.dryrun``.

For each cell this runs what one rank of the meshed steps computes
(``repro_torch.train.step``: ``make_train_step``, ``make_prefill_step``,
``make_serve_step``) on ``meta`` tensors — the loss and its backward
(``train_4k``), ``bundle.prefill`` for prefill cells and one
``decode_step`` for decode cells — on the rank's rows of the cell's global
batch with gathered parameters (the steps themselves need a live mesh).  The mesh is a ``MeshShape`` of the
production mesh, (data=16, model=16) or (pod=2, data=16, model=16): no
process group and no device is needed.  It records:

  * ``model_flops``, the reference's 6·N·D (2·N·D for serving; MoE counts
    the active experts), and the FLOPs the rank's step runs, from
    ``torch.utils.flop_counter.FlopCounterMode`` (the kernels K5-K8 count
    through their meta ops' formulas, ``kernels/meta.py``);
  * per-rank bytes of the parameters, gradients and AdamW moments under
    ``auto_param_sharding``'s placements, and of the cache under
    ``cache_sharding``'s;
  * activation bytes saved for the backward: what autograd packs
    (``torch.autograd.graph.saved_tensors_hooks``, each storage once,
    parameters left out), the layer inputs remat keeps, and one layer's
    saved set, which the backward recomputes layer by layer;
  * collective bytes a rank moves: the all-gather of each parameter
    (its full size less the local shard; a layer's again in the backward
    under remat, which recomputes the layer) and the reduction of its
    gradient over the ranks holding other rows (a reduce-scatter where
    the parameter is sharded over them, an all-reduce where it is not),
    worked out from the placements;
  * roofline terms on the card's peaks (``hlo_analysis``), with an HBM
    byte count that is a floor: each gathered parameter read once a
    forward (twice under remat) and once in the backward, each gradient
    written once, AdamW's seven reads and writes of the local state, the
    saved activations written and read once (no op-level byte count
    exists on ``meta``).

In place of XLA's ``memory_analysis``, ``peak_bytes`` estimates a rank's
peak in the train step: its state, its gradient shards, the gathered
parameters and their full gradients alive at once (the embedding's for
the whole step, one layer's at a time under remat, every layer's without
it), and the larger of the activations and the in-place AdamW update's
two fp32 temporaries of the largest leaf.  The activations count the
saved tensors, remat's layer inputs, one recomputed layer's saved set and
the largest workspace a K7 or K8 backward launch takes (its stored states
and partial sums, ``meta.scan_bwd_workspace_bytes``), which lives while
that layer's backward runs.  Cells ``bundle.runnable``
refuses are ``skipped`` with the reason (the port trains every arch).  The
``chunked-attn`` variants set ``attn_impl``, which only the CPU route of
the kernel API reads: on the card and here K5 is the one route.

Results are written incrementally to ``--out`` (default ``dryrun_out/``)
as JSON, one file a cell, so a sweep can resume.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out dryrun_out
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCHS, SHAPES_BY_NAME, get_arch
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed.sharding import (
    DEFAULT_RULES, AxisRules, _axes, auto_param_sharding,
)
from repro_torch.kernels import meta
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import (
    describe, mesh_shape, production_mesh_shape,
)
from repro_torch.models import backbone as B
from repro_torch.models.registry import build

RESULTS_DIR = Path("dryrun_out")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    return [(path, tree)]


def _nbytes(t) -> int:
    return math.prod(t.shape) * t.element_size()


def model_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); D = tokens/step.

    For decode cells D = global_batch tokens (one step).
    """
    shapes = build(cfg).param_shapes()
    total = routed = 0
    for path, leaf in _leaves(shapes):
        n = math.prod(leaf.shape)
        total += n
        if "experts" in path:
            routed += n
    if cfg.moe is not None:
        active = total - routed + routed * cfg.moe.top_k / cfg.moe.n_experts
    else:
        active = total
    d_tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    mult = 6 if cell.kind == "train" else 2
    return mult * active * d_tokens


VARIANTS = {
    # §Perf variants: config / step-builder deltas applied on top of the
    # paper-faithful baseline.  Results land in ...__<variant>.json.
    None: {},
    "chunked-attn": {"cfg": {"attn_impl": "chunked"}},
    "no-remat": {"cfg": {"remat": False}},
    "gradcomp": {"step": {"grad_compression": True}},
    "microbatch4": {"step": {"microbatches": 4}},
    "microbatch8": {"step": {"microbatches": 8}},
    "chunked+mb8": {"cfg": {"attn_impl": "chunked"},
                    "step": {"microbatches": 8}},
    # widen the batch axis over the model axis too (removes replicated
    # attention compute for archs whose heads don't divide model=16)
    "dp-wide": {"rules": {"dp": ("pod", "data", "model")}},
    "chunked+dpwide": {"cfg": {"attn_impl": "chunked"},
                       "rules": {"dp": ("pod", "data", "model")}},
    # serving: bf16 parameters halve the per-token weight traffic (decode
    # is weight/cache-bandwidth bound)
    "bf16-params": {"cfg": {"param_dtype": "bfloat16"}},
    "bf16+chunked": {"cfg": {"param_dtype": "bfloat16",
                             "attn_impl": "chunked"}},
    # serving: TP-only parameter sharding (no per-step FSDP weight gather;
    # costs replicated weight memory across the dp axis)
    "bf16+tponly": {"cfg": {"param_dtype": "bfloat16"}, "fsdp_axes": ()},
}


# ---------------------------------------------------------------------------
# bytes from placements


def _shardings(cfg: ArchConfig, mesh, fsdp_axes=None):
    shapes = build(cfg).param_shapes()
    return shapes, auto_param_sharding(shapes, mesh, fsdp_axes=fsdp_axes)


def state_bytes(cfg: ArchConfig, mesh, grad_compression: bool = False,
                fsdp_axes=None) -> int:
    """A rank's bytes of the train state on ``mesh`` (a ``MeshShape`` or a
    live mesh): its shards of the parameters and of AdamW's two fp32
    moments (and of the fp32 error state under gradient compression)."""
    return _param_bytes(cfg, mesh, fsdp_axes, grad_compression)["state"]


def _param_bytes(cfg: ArchConfig, mesh, fsdp_axes, grad_compression: bool,
                 row_axes=()) -> Dict[str, int]:
    shapes, sh = _shardings(cfg, mesh, fsdp_axes)
    sizes = mesh_shape(mesh).shape
    n_rows = math.prod(sizes[a] for a in row_axes)
    out = dict.fromkeys(("params", "full_params", "adamw", "err",
                         "gather", "grad_reduce", "largest", "gather_top",
                         "gather_layer", "regather"), 0)
    flat_sh = dict(_leaves(sh))
    for path, leaf in _leaves(shapes):
        s = flat_sh[path]
        local = math.prod(s.shard_shape(leaf.shape))
        full = math.prod(leaf.shape)
        item = leaf.element_size()
        out["params"] += local * item
        out["full_params"] += full * item
        out["adamw"] += 2 * local * 4
        out["err"] += local * 4 if grad_compression else 0
        out["gather"] += (full - local) * item
        out["largest"] = max(out["largest"], local * 4)
        if local < full:  # the step gathers a new full tensor
            if path[0] == "layers" and not s.spec[0]:
                out["gather_layer"] += full * item // leaf.shape[0]
                out["regather"] += (full - local) * item
            else:  # whole for the step (a 2-D stacked leaf cut by layer too)
                out["gather_top"] += full * item
        if n_rows > 1:
            used = {a for part in s.spec for a in _axes(part)}
            over_rows = set(row_axes) <= used
            ring = full * item * (n_rows - 1) / n_rows
            out["grad_reduce"] += int(ring if over_rows else 2 * ring)
    out["state"] = out["params"] + out["adamw"] + out["err"]
    return out


# ---------------------------------------------------------------------------
# the meta runs


class _Saved:
    """Bytes autograd packs for the backward: each storage once, the
    parameters left out."""

    def __init__(self, params):
        self.skip = {t.untyped_storage()._cdata for _p, t in _leaves(params)}
        self.seen = set()
        self.bytes = 0

    def pack(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key not in self.skip and key not in self.seen:
            self.seen.add(key)
            self.bytes += st.nbytes()
        return t

    @staticmethod
    def unpack(t):
        return t


@contextlib.contextmanager
def _remat_inputs(counter: list):
    """Counts the tensors remat keeps for each layer (the checkpointed
    call's tensor arguments, held by its recompute closure rather than
    packed)."""
    real = B.checkpoint
    seen = set()

    def counted(fn, *args, **kw):
        for a in args:
            if torch.is_tensor(a) and a.untyped_storage()._cdata not in seen:
                seen.add(a.untyped_storage()._cdata)
                counter[0] += a.untyped_storage().nbytes()
        return real(fn, *args, **kw)

    B.checkpoint = counted
    try:
        yield
    finally:
        B.checkpoint = real


def _meta_params(bundle, grad: bool):
    params = bundle.param_shapes()
    for _p, t in _leaves(params):
        t.requires_grad_(grad)
    return params


def _flop_counter():
    """A ``FlopCounterMode`` that knows the kernels' meta ops (it copies
    the registry of formulas when it is made)."""
    from torch.utils.flop_counter import FlopCounterMode

    meta.ops()
    return FlopCounterMode(display=False)


def _ids(shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def meta_train(cfg: ArchConfig, rows: int, seq: int) -> Dict:
    """The train step's loss and backward on ``rows`` sequences of ``seq``
    tokens on ``meta``: FLOPs (total and by op) and the activation bytes
    (saved for the backward, and the largest scan backward's workspace;
    see the module docstring)."""
    bundle = build(cfg)
    params = _meta_params(bundle, grad=True)
    shape = bundle._token_shape(rows, seq)
    batch = {"tokens": _ids(shape), "labels": _ids(shape)}
    saved = _Saved(params)
    remat = [0]
    flops = _flop_counter()
    meta.workspace_peak(reset=True)
    with flops, _remat_inputs(remat), torch.autograd.graph.saved_tensors_hooks(
            saved.pack, saved.unpack):
        loss, _m = bundle.loss(params, batch)
        torch.autograd.grad(loss, [t for _p, t in _leaves(params)])
    workspace = meta.workspace_peak(reset=True)
    layer = 0
    if cfg.remat:
        # one layer's saved set, live while the backward recomputes it
        p1 = B._layer_slice(params["layers"], 0)
        x = torch.empty((rows, seq, cfg.d_model), device="meta",
                        dtype=getattr(torch, cfg.compute_dtype),
                        requires_grad=True)
        one = _Saved(params)
        with torch.autograd.graph.saved_tensors_hooks(one.pack, one.unpack):
            B.block_apply_aux(p1, x, cfg, B._positions(rows, seq, "meta"))
        layer = one.bytes
    return {"flops": float(flops.get_total_flops()),
            "flops_by_op": {str(k): float(v) for k, v in
                            flops.get_flop_counts()["Global"].items()},
            "saved_bytes": saved.bytes, "remat_input_bytes": remat[0],
            "recompute_layer_bytes": layer, "bwd_workspace_bytes": workspace,
            "activation_bytes": saved.bytes + remat[0] + layer + workspace}


def meta_serve(cfg: ArchConfig, cell: ShapeCell, rows: int) -> Dict:
    """``prefill`` (prefill cells) or one ``decode_step`` against a cache of
    ``cell.seq_len`` (decode cells) on ``rows`` sequences on ``meta``:
    FLOPs and the bytes of the rows' cache."""
    bundle = build(cfg)
    params = _meta_params(bundle, grad=False)
    flops = _flop_counter()
    with flops, torch.no_grad():
        if cell.kind == "prefill":
            _l, cache = bundle.prefill(
                params, _ids(bundle._token_shape(rows, cell.seq_len)),
                max_len=cell.seq_len)
        else:
            cache = bundle.init_cache(rows, cell.seq_len, device="meta")
            bundle.decode_step(params, _ids(bundle._token_shape(rows, 1)),
                               cache, _ids((rows,)))
    return {"flops": float(flops.get_total_flops()),
            "flops_by_op": {str(k): float(v) for k, v in
                            flops.get_flop_counts()["Global"].items()},
            "cache_rows_bytes": sum(_nbytes(t) for _p, t in _leaves(cache))}


def _cache_bytes(cfg: ArchConfig, cell: ShapeCell, rules: AxisRules) -> int:
    """A rank's bytes of the cell's cache under ``cache_sharding``."""
    from repro_torch.train.step import cache_sharding

    shapes = build(cfg).init_cache(cell.global_batch, cell.seq_len,
                                   device="meta")
    sh = dict(_leaves(cache_sharding(rules.shape, shapes, rules)))
    return sum(math.prod(sh[p].shard_shape(t.shape)) * t.element_size()
               for p, t in _leaves(shapes))


def train_memory(cfg: ArchConfig, mesh, rows: int, seq: int,
                 grad_compression: bool = False, fsdp_axes=None,
                 row_axes=()) -> Dict:
    """A rank's bytes in the train step at ``rows`` x ``seq`` tokens:
    ``state``, ``grads`` (its shards), ``gathered_params`` (the gathered
    tensors and their full gradients alive at once), ``activation_bytes``
    and ``peak_bytes`` (module docstring)."""
    pb = _param_bytes(cfg, mesh, fsdp_axes, grad_compression, row_axes)
    act = meta_train(cfg, rows, seq)
    # the embedding's tensors are gathered for the whole step, and their
    # full gradients fill through the backward; a layer's under remat only
    # while it runs (its gradient's full size until it is scattered), and
    # without remat every layer's stays for the backward
    layers = (2 * pb["gather_layer"] if cfg.remat
              else (cfg.n_layers + 1) * pb["gather_layer"])
    gathered = 2 * pb["gather_top"] + layers
    # the backward holds the activations, the AdamW update two fp32
    # temporaries of its largest leaf
    update = 2 * pb["largest"]
    peak = (pb["state"] + pb["params"] + gathered
            + max(act["activation_bytes"], update))
    return {"state": pb["state"], "params": pb["params"],
            "grads": pb["params"], "adamw": pb["adamw"], "err": pb["err"],
            "gathered_params": gathered,
            "activation_bytes": act["activation_bytes"],
            "update_temp_bytes": update, "peak_bytes": peak,
            "_param": pb, "_meta": act}


# ---------------------------------------------------------------------------
# one cell


def lower_cell(arch: str, shape: str, multi_pod: bool,
               variant: Optional[str] = None) -> Dict:
    cfg = get_arch(arch)
    cell = SHAPES_BY_NAME[shape]
    head = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
            "variant": variant}
    ok, reason = build(cfg).runnable(cell)
    if not ok:
        return {**head, "status": "skipped", "reason": reason}

    vspec = VARIANTS[variant]
    cfg = cfg.with_(**vspec.get("cfg", {}))
    step_kw = dict(vspec.get("step", {}))
    fsdp_axes = (tuple(vspec["fsdp_axes"]) if "fsdp_axes" in vspec else None)
    mapping = ({**DEFAULT_RULES, **vspec["rules"]} if vspec.get("rules")
               else None)
    mesh = production_mesh_shape(multi_pod)
    rules = AxisRules(mesh, mapping)
    n_chips = mesh.size
    tok = build(cfg)._token_shape(cell.global_batch,
                                  cell.seq_len if cell.kind != "decode" else 1)
    row_axes = _axes(rules.spec(["dp"] + [None] * (len(tok) - 1), tok)[0])
    n_rows = math.prod(mesh.shape[a] for a in row_axes)
    rows = cell.global_batch // n_rows
    mb = step_kw.get("microbatches", 1)

    t0 = time.time()
    pb = _param_bytes(cfg, mesh, fsdp_axes,
                      step_kw.get("grad_compression", False), row_axes)
    rec_mem: Dict = {}
    if cell.kind == "train":
        mem = train_memory(cfg, mesh, rows // mb, cell.seq_len,
                           step_kw.get("grad_compression", False), fsdp_axes,
                           row_axes)
        run = mem.pop("_meta")
        mem.pop("_param")
        flops = run["flops"] * mb
        passes = 3 if cfg.remat else 2
        hbm = (pb["full_params"] * passes * mb + pb["full_params"] * mb
               + 7 * (pb["params"] + pb["adamw"] // 2)
               + 2 * run["activation_bytes"] * mb)
        # under remat the backward gathers each layer again
        grad_reduce = pb["grad_reduce"] * mb
        coll = (pb["gather"] + (pb["regather"] if cfg.remat else 0)) * mb \
            + grad_reduce
        rec_mem = {**mem, "saved_bytes": run["saved_bytes"],
                   "remat_input_bytes": run["remat_input_bytes"],
                   "recompute_layer_bytes": run["recompute_layer_bytes"]}
    else:
        run = meta_serve(cfg, cell, rows)
        flops = run["flops"]
        hbm = pb["full_params"] + run["cache_rows_bytes"]
        coll, grad_reduce = pb["gather"], 0
        rec_mem = {"params": pb["params"], "gathered_params": pb["gather"],
                   "cache_bytes": _cache_bytes(cfg, cell, rules),
                   "cache_rows_bytes": run["cache_rows_bytes"]}
    seconds = time.time() - t0

    mf = model_flops(cfg, cell)
    terms = H.roofline_terms(flops, hbm, coll, n_chips)
    per_device_mf = mf / n_chips
    return {
        **head,
        "mesh": describe(mesh),
        "n_chips": n_chips,
        "status": "ok",
        "rows_per_rank": rows,
        "row_axes": list(row_axes),
        "meta_s": round(seconds, 3),
        "flops": flops,
        "flops_by_op": run["flops_by_op"],
        "hbm_bytes_floor": hbm,
        "collective_bytes": coll,
        "collectives": {"param_all_gather": coll - grad_reduce,
                        "grad_reduction": grad_reduce},
        "memory": rec_mem,
        "roofline": terms,
        "card": H.card(),
        "model_flops": mf,
        "model_flops_per_device": per_device_mf,
        "useful_fraction": per_device_mf / flops if flops else None,
    }


def result_path(arch: str, shape: str, multi_pod: bool,
                variant: Optional[str] = None,
                out_dir: Path = RESULTS_DIR) -> Path:
    mesh_tag = "multipod" if multi_pod else "singlepod"
    vtag = f"__{variant}" if variant else ""
    return Path(out_dir) / f"{arch}__{shape}__{mesh_tag}{vtag}.json"


def run_one(arch: str, shape: str, multi_pod: bool, force: bool = False,
            variant: Optional[str] = None,
            out_dir: Path = RESULTS_DIR) -> dict:
    out = result_path(arch, shape, multi_pod, variant, out_dir)
    if out.exists() and not force:
        return json.loads(out.read_text())
    try:
        rec = lower_cell(arch, shape, multi_pod, variant=variant)
    except Exception as e:  # record failures: they are bugs to fix
        rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
               "variant": variant,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), action="append")
    ap.add_argument("--shape", choices=sorted(SHAPES_BY_NAME), action="append")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", choices=[v for v in VARIANTS if v],
                    default=None)
    ap.add_argument("--out", default=str(RESULTS_DIR),
                    help="directory of the JSON records (default "
                         "dryrun_out)")
    args = ap.parse_args(argv)

    archs = args.arch or (sorted(ARCHS) if args.all else [])
    shapes = args.shape or (sorted(SHAPES_BY_NAME) if args.all or args.arch else [])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if not archs:
        ap.error("pass --arch/--shape or --all")

    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_one(arch, shape, mp, force=args.force,
                              variant=args.variant, out_dir=Path(args.out))
                records.append(rec)
                status = rec["status"]
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f"meta={rec['meta_s']}s "
                             f"dominant={r['dominant']} "
                             f"flops={rec['flops']:.3g}")
                elif status == "error":
                    extra = rec["error"][:120]
                else:
                    extra = rec["reason"]
                print(f"[{status:7s}] {arch:18s} {shape:12s} "
                      f"{'multi' if mp else 'single'}  {extra}", flush=True)
    return records


if __name__ == "__main__":
    main()
