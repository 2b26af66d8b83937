"""Salvage a torn RNT-J file: scan its commit journal and rebuild the
footer, the twin of the JAX package's ``tools/recover.py``.

The writing process died before finalization (or the footer region is
corrupt): the anchor/footer/page-list chain is missing, so the normal
reader refuses the file — even though every committed cluster's bytes are
intact.  This tool runs :func:`repro_torch.core.recover.recover_container`
over the file: it walks the data region's cluster envelopes + journal
records, validates page checksums, drops torn/corrupt clusters, and
appends a fresh page list + footer + anchor covering exactly what
survived.  The file then opens normally and every salvaged entry reads
back byte-identically.  Recovery is host work: it runs no kernel.

Run:
    python -m repro_torch.launch.recover FILE            # recover in place
    python -m repro_torch.launch.recover FILE -o OUT     # recover a copy
    python -m repro_torch.launch.recover FILE --dry-run  # report only

Exit status: 0 when the file is healthy or was rebuilt, 1 when it cannot
be salvaged (e.g. the header itself is torn), 2 on bad usage.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core import RecoveryError, recover_container


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="salvage a torn RNT-J file from its commit journal"
    )
    ap.add_argument("file", help="the (possibly torn) RNT-J file")
    ap.add_argument("-o", "--output", default=None,
                    help="write the recovered file here instead of in place")
    ap.add_argument("--dry-run", action="store_true",
                    help="scan and report only; write nothing")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip per-page checksum validation (faster, riskier)")
    ap.add_argument("--force", action="store_true",
                    help="rebuild even when the existing footer is valid")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the full report as JSON")
    args = ap.parse_args(argv)

    try:
        report = recover_container(
            args.file,
            output=args.output,
            dry_run=args.dry_run,
            verify_pages=not args.no_verify,
            force=args.force,
        )
    except RecoveryError as e:
        print(f"unrecoverable: {e}", file=sys.stderr)
        return 1

    if args.as_json:
        print(json.dumps(report.as_dict(), indent=2))
        return 0
    if report.footer_valid:
        print(f"{args.file}: footer chain valid "
              f"({report.entries_salvaged} entries) — nothing to do"
              " (use --force to rebuild anyway)")
        return 0
    verb = "would salvage" if args.dry_run else "salvaged"
    where = args.output or args.file
    print(f"{where}: {verb} {report.clusters_salvaged} clusters / "
          f"{report.entries_salvaged} entries "
          f"(dropped {len(report.clusters_dropped)}, "
          f"journal records {report.journal_records}, "
          f"resyncs {report.resyncs}, "
          f"scanned {report.scan_bytes} bytes "
          f"in {report.scan_seconds * 1e3:.1f} ms)")
    for d in report.clusters_dropped:
        print(f"  dropped cluster seq={d['seq']}: {d['reason']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
