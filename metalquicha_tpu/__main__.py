"""Command-line entry point: `python -m metalquicha_tpu input.mqc`.

Parity with the reference executable (/root/reference/app/main.f90): parses
the input, runs the calculation, writes `output_<base>.json` in the CWD and
prints a summary. `--version` prints the version string.
"""

from __future__ import annotations

import argparse
import sys
import time

LOGO = r"""
                 _        _            _      _           _
  _ __ ___   ___| |_ __ _| | __ _ _  _(_) ___| |__   __ _| |
 | '_ ` _ \ / _ \ __/ _` | |/ _` | || | |/ __| '_ \ / _` | |
 | | | | | |  __/ || (_| | | (_| | \_,_|_| (__| | | | (_| |_|
 |_| |_| |_|\___|\__\__,_|_|\__, |_____|\___|_| |_|\__,_(_)
                               |_|
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mqc", description="fragmented quantum chemistry"
    )
    ap.add_argument("input", nargs="?", help="input .mqc file")
    ap.add_argument("--version", action="store_true")
    ap.add_argument("--platform", default=None,
                    help="force a JAX platform (cpu/cuda)")
    ap.add_argument("--f32", action="store_true",
                    help="force the float32 working dtype (default: by "
                         "backend — f32 on an accelerator, f64 on CPU)")
    ap.add_argument("--no-polish", action="store_true",
                    help="disable the f64 host polish of f32 device "
                         "results (raw device precision)")
    args = ap.parse_args(argv)

    from . import __version__

    if args.version:
        print(f"mqc (metalquicha) version {__version__}")
        return 0
    if not args.input:
        ap.error("input file required")

    from .runtime import configure_runtime

    configure_runtime(args.platform)

    print(LOGO)
    print(f" version {__version__}\n")

    from .driver import run_file
    from .io.json_writer import output_filename_for

    overrides = {}
    if args.f32:
        overrides["force_dtype"] = "f32"
    if args.no_polish:
        overrides["host_polish"] = "off"

    t0 = time.time()
    outputs = run_file(args.input, driver_overrides=overrides)
    elapsed = time.time() - t0

    for name, out in outputs.items():
        label = name or "total"
        print(f" {label}: total_energy = {out.result.total_energy:.12f} Ha")
        if out.result.gradient is not None:
            gn = float((out.result.gradient**2).sum() ** 0.5)
            print(f" {label}: gradient_norm = {gn:.9f}")
        if out.result.hessian is not None:
            hn = float((out.result.hessian**2).sum() ** 0.5)
            print(f" {label}: hessian_frobenius_norm = {hn:.9f}")

    # parting fact + total timer, matching the reference's rank-0 epilogue
    # (app/main.f90:130-132: get_knowledge + "Total processing time")
    from .logging_ import get_knowledge

    print(f"\n output written to {output_filename_for(args.input)}")
    print(f" {get_knowledge()}")
    print(f" Total processing time: {elapsed:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
