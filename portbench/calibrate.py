"""Readings for a cell's correctness limits, at the cell's own size, in
one process (set-up is paid once a seed, not once a run):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control 1,2,3 --fault 4,5,6 --out <file.jsonl>

Training: for each of ``--seeds`` the program's checked steps against
the reference (sound runs: the lower readings); for each of
``--control`` also the reference computed with float8 products in the
program's place (the control), on that seed's batches; for each of
``--fault`` the program with half of each batch left out
(``portbench.faults``).  Serving: see
:func:`serve`.  One JSON line a reading.  Not run by the benchmark's
runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control", type=_ints, default=[])
    ap.add_argument("--fault", type=_ints, default=[])
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=None,
                    help="a benchmark root other than portbench/ (tests)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]

    import torch

    from portbench import faults, spec
    from portbench.drivers import train
    from portbench.reference import compare
    from portbench.reference.model import fp8_mm, train_readings

    cell, cfg, traffic = spec.load_cell(args.workload,
                                        Path(args.root or spec.ROOT))
    dev = torch.device(args.device)
    if traffic["driver"] == "serve":
        return serve(args, cfg, traffic, dev)
    jobs = ([(s, "program") for s in args.seeds]
            + [(s, "fault") for s in args.fault])
    with open(args.out, "a") as out:
        for seed, kind in jobs:
            t0 = time.perf_counter()
            work = Path(tempfile.mkdtemp(prefix="portbench-cal-"))
            try:
                with (faults.planted("train", "half_batch") if kind == "fault"
                      else contextlib.nullcontext()):
                    loop, loader, readings, docs = train.setup(
                        cfg, traffic, seed, dev, work, keep_grad=True)
                kept = loader.kept
                del loop, loader
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                wrong, batches = train.reference_batches(traffic, docs, kept)
                rows = []
                if batches is None:
                    rec = {"workload": args.workload, "seed": seed, "kind": kind,
                           "numbers": {"loader_tokens_wrong": wrong}}
                    print(json.dumps(rec), flush=True)
                    out.write(json.dumps(rec) + "\n")
                else:
                    control = kind == "program" and seed in args.control
                    ref = train_readings(cfg, traffic["optimizer"], seed,
                                         batches, dev,
                                         first_grad=readings["first_grad"],
                                         keep_first=control,
                                         first_scale=1 / (1 - traffic["optimizer"]["b1"]))
                    rows.append((kind, readings, ref))
                    if control:
                        ctl = train_readings(cfg, traffic["optimizer"], seed,
                                             batches, dev, fp8_mm,
                                             first_grad=ref.pop("first_grad"))
                        # the control's difference is the reference's against it
                        rows.append(("control", ctl, dict(
                            ref, grad_diff=ctl.pop("grad_diff"))))
                for k, got, against in rows:
                    numbers = compare.train_numbers(got, against)
                    numbers["loader_tokens_wrong"] = wrong
                    rec = {"workload": args.workload, "seed": seed, "kind": k,
                           "numbers": numbers,
                           "detail": compare.train_detail(got, against),
                           "seconds": time.perf_counter() - t0}
                    print(json.dumps(rec), flush=True)
                    out.write(json.dumps(rec) + "\n")
                    out.flush()
            finally:
                shutil.rmtree(work, ignore_errors=True)
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
    return 0


def serve(args, cfg, traffic, dev) -> int:
    """A serving cell: for each seed, every shape of the cycle once in the
    seed's order (the longest among them), then the reference's widest
    gap over the checked requests, and the float8 control's on the same
    requests for ``--control``'s seeds."""
    import torch

    from portbench.drivers import serve as drv
    from portbench.reference.model import fp8_mm, served_gaps

    bundle = drv.build_bundle(cfg)
    n = len(drv.lengths_cycle(traffic))
    with open(args.out, "a") as out:
        for seed in args.seeds:
            t0 = time.perf_counter()
            work = Path(tempfile.mkdtemp(prefix="portbench-cal-"))
            try:
                params = drv.draw_params(bundle, cfg, seed, dev)
                rec = drv.serve_batches(bundle, params, traffic, cfg, seed, dev,
                                        0.0, str(work / "g.rntj"), n_batches=n)
                del params
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                gaps = served_gaps(cfg, seed, drv.checked(rec["served"], traffic, seed),
                                   dev, fp8_mm if seed in args.control else None)
            finally:
                shutil.rmtree(work, ignore_errors=True)
            for kind in ("served", "control"):
                if gaps[kind]:
                    rec_out = {"workload": args.workload, "seed": seed,
                               "kind": "program" if kind == "served" else kind,
                               "numbers": {"served_logit_gap": max(gaps[kind])},
                               "detail": gaps[kind],
                               "seconds": time.perf_counter() - t0}
                    print(json.dumps(rec_out), flush=True)
                    out.write(json.dumps(rec_out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
