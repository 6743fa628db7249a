"""Command-line interface mirroring the reference's flags.

Reference parser: init_args (src/IMSAME.c:520-578).  Same flags, same
defaults, same quirks (-igap/-egap negate user input; --verbose accepted
and ignored).  Additional engine tunables are namespaced under --engine-*.
"""

from __future__ import annotations

import argparse
import sys
import time

from .config import Config
from .io.fasta import read_fasta
from .io.report import format_summary
from .pipeline import TpuEngine
from .utils.timing import gcups


# Byte-exact copy of the reference's --help block (src/IMSAME.c:526-538;
# printed verbatim, then exit(1) exactly like the reference).  The unbalanced
# brackets on -coverage/-identity/-igap/-egap are the reference's own.
REFERENCE_HELP = (
    "USAGE:\n"
    "           IMSAME -query [query] -db [database]\n"
    "OPTIONAL:\n"
    "           -n_threads  [Integer:   0<n_threads] (default 4)\n"
    "           -evalue     [Double:    0<=pval<1] (default: 1 * 10^-20)\n"
    "           -coverage   [Double:    0<coverage<=1 (default: 0.5)\n"
    "           -identity   [Double:    0<identity<=1 (default: 0.5)\n"
    "           -igap       [Integer:   (default: 5)\n"
    "           -egap       [Integer:   (default: 2)\n"
    "           -out        [File path]\n"
    "           --verbose   Turns verbose on\n"
    "           --help      Shows help for program usage\n"
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="imsame-tpu",
        description="all-vs-all metagenome read comparison on JAX "
        "(capabilities of the reference IMSAME binary)",
        add_help=False,  # --help is reference-parity (REFERENCE_HELP);
        # the argparse-generated help lives on --help-engine
    )
    p.add_argument("--help-engine", action="help",
                   help="full flag listing (incl. --engine-* tunables)")
    p.add_argument("-query", required=True, help="query FASTA")
    p.add_argument("-db", required=True, help="database FASTA")
    p.add_argument("-out", default=None, help="alignment report output path")
    p.add_argument("-n_threads", type=int, default=4,
                   help="reference thread count to emulate for stream parity")
    p.add_argument("-evalue", type=float, default=1e-20)
    p.add_argument("-coverage", type=float, default=0.5)
    p.add_argument("-identity", type=float, default=0.5)
    p.add_argument("-igap", type=int, default=5,
                   help="gap open penalty (negated, like the reference)")
    p.add_argument("-egap", type=int, default=2,
                   help="gap extend penalty (negated, like the reference)")
    p.add_argument("--verbose", action="store_true",
                   help="accepted for compatibility; ignored (as upstream)")
    p.add_argument("--engine-first-window", type=int, default=8,
                   help="candidates gated per read in stage 1")
    p.add_argument("--engine-gate-chunks", type=str, default="524288,65536",
                   help="fixed flat-gate chunk sizes (comma-separated)")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    if args.evalue < 0:
        raise SystemExit("ERR**** Min-e-value must be larger than zero ****")
    if args.coverage <= 0:
        raise SystemExit("ERR**** Min-coverage must be larger than zero ****")
    if args.identity <= 0:
        raise SystemExit("ERR**** Min-identity must be larger than zero ****")
    return Config(
        min_e_value=args.evalue,
        min_coverage=args.coverage,
        min_identity=args.identity,
        igap=-args.igap,
        egap=-args.egap,
        n_threads=max(1, args.n_threads),
        first_window=args.engine_first_window,
        gate_chunks=tuple(
            int(x) for x in args.engine_gate_chunks.split(",") if x
        ),
    )


def main(argv=None) -> int:
    """Stdout [INFO] lines byte-match the reference main
    (src/IMSAME.c:63,102,106,295,317,407,416,470-473), with wall-clock
    timings where the reference reports clock() CPU-seconds."""
    t0 = time.perf_counter()
    # Reference parity: --help anywhere in argv prints the usage block and
    # exits 1, before any other flag handling (src/IMSAME.c:525-539).
    scan = sys.argv[1:] if argv is None else list(argv)
    if "--help" in scan:
        sys.stdout.write(REFERENCE_HELP)
        return 1
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    print("[INFO] Init. quick table")
    print(f"[INFO] Initialization took {time.perf_counter() - t0:e} seconds ")
    print("[INFO] Loading database")
    t1 = time.perf_counter()
    db = read_fasta(args.db)
    eng = TpuEngine(db, cfg)  # dict build is part of the db-load phase,
    # like the reference's inline insert loop (src/IMSAME.c:196-289)
    print(
        f"[INFO] Database loaded and of length {db.total_len}. "
        f"Hash table building took {time.perf_counter() - t1:e} seconds"
    )
    print("[INFO] Loading query.")
    t2 = time.perf_counter()
    q = read_fasta(args.query)
    print(
        f"[INFO] Query loaded and of length {q.total_len}. "
        f"Took {time.perf_counter() - t2:e} seconds"
    )

    print("[INFO] Computing alignments.")
    t3 = time.perf_counter()
    res = eng.compare(q)
    t4 = time.perf_counter()
    if args.out:
        with open(args.out, "wb") as f:
            f.write(eng.render_report(q, res))

    print(f"[INFO] Alignments computed in {t4 - t3:e} seconds.")
    print(format_summary(res.accepted, res.n_query, res.n_db,
                         cfg.min_e_value, cfg.min_coverage))
    print("[INFO] Deallocating heap memory.")
    if args.verbose:
        print(
            f"[INFO] {res.n_candidates} seed candidates, "
            f"{res.nw_cells} DP cells "
            f"({gcups(res.nw_cells, t4 - t3):.3f} GCUPS), "
            f"{res.n_query / max(t4 - t3, 1e-9):.0f} reads/s, "
            f"total {time.perf_counter() - t0:.2f}s"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
