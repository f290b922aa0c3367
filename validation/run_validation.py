#!/usr/bin/env python3
"""Physics validation runner.

Converts the JSON inputs to .mqc, runs each calculation IN-PROCESS (shared
jit cache across tests), and compares against the upstream expected values
in expected.json. Reports hard pass/fail at --tol plus raw deltas so
parameter-calibration progress is visible even before exact parity.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--filter", default=None)
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--platform", default="cpu", choices=("cpu", "cuda"),
                    help="JAX platform: cpu (the f64 parity path) or cuda "
                         "(f32 device SCC + f64 host polish)")
    ap.add_argument("--f32", action="store_true",
                    help="force the float32 device dtype (the accelerator "
                         "working precision; default: by backend — f64 on "
                         "CPU)")
    ap.add_argument("--polish", default="auto", choices=("auto", "off"),
                    help="f64 host polish of f32 device results (auto = "
                         "on whenever the device dtype is f32; off = raw "
                         "device precision)")
    ap.add_argument("--json-out", default=None,
                    help="write per-case results/deltas to this JSON file")
    ap.add_argument("--skip-slow", action="store_true",
                    help="skip w20/gly10-scale tests")
    args = ap.parse_args()

    from metalquicha_tpu.runtime import configure_runtime

    configure_runtime(args.platform)

    from metalquicha_tpu.driver import run_calculation
    from metalquicha_tpu.io.config import parse_mqc_string
    from metalquicha_tpu.io.prep import emit_mqc

    with open(os.path.join(HERE, "expected.json")) as fh:
        manifest = json.load(fh)
    tol = args.tol if args.tol is not None else manifest["tolerance"]

    tests = manifest["tests"]
    if args.filter:
        tests = [t for t in tests if args.filter.lower() in t["name"].lower()]
    if args.skip_slow:
        tests = [t for t in tests if t["name"] not in ("w20_mbe", "gly10_mbe")]

    passed = failed = errored = 0
    rows = []
    json_rows = []
    for i, test in enumerate(tests, 1):
        name = test["name"]
        json_path = os.path.join(HERE, "inputs", test["input"])
        t0 = time.time()
        try:
            with open(json_path) as fh:
                data = json.load(fh)
            mqc_text = emit_mqc(data, base_dir=os.path.dirname(json_path))
            cfg = parse_mqc_string(mqc_text)
            overrides = {"host_polish": args.polish}
            if args.f32:
                overrides["force_dtype"] = "f32"
            outputs = run_calculation(cfg, input_path=test["input"],
                                      write_json=False,
                                      driver_overrides=overrides)
        except Exception as exc:  # noqa: BLE001
            errored += 1
            rows.append((name, "ERROR", str(exc)[:80], time.time() - t0))
            continue

        checks = []
        if "energy" in test:
            got = outputs[""].result.total_energy
            checks.append(("energy", got, test["energy"]))
        if "energies" in test:
            for mol, exp in test["energies"].items():
                got = outputs[mol].result.total_energy
                checks.append((f"energy[{mol}]", got, exp))
        if "gradient_norm" in test:
            g = outputs[""].result.gradient
            got = float(math.sqrt(float((g**2).sum())))
            checks.append(("grad_norm", got, test["gradient_norm"]))
        if "hessian_frobenius_norm" in test:
            h = outputs[""].result.hessian
            got = float(math.sqrt(float((h**2).sum())))
            checks.append(("hess_norm", got, test["hessian_frobenius_norm"]))
        if "zpe" in test:
            checks.append(
                ("zpe", outputs[""].thermo.zpe_hartree, test["zpe"])
            )
        if "gibbs_correction" in test:
            checks.append(
                ("gibbs", outputs[""].thermo.thermal_correction_gibbs,
                 test["gibbs_correction"])
            )
        if "frequencies" in test:
            freqs = sorted(outputs[""].vibrational.frequencies)
            exp = sorted(test["frequencies"])
            # compare the significant (non near-zero) modes at 0.1 cm-1
            sig_got = [f for f in freqs if abs(f) > 1.0]
            sig_exp = [f for f in exp if abs(f) > 1.0]
            if len(sig_got) == len(sig_exp):
                worst = max(
                    abs(a - b) for a, b in zip(sig_got, sig_exp)
                )
                checks.append(("freq_max_dev_cm1", worst, 0.0))

        worst_delta = 0.0
        ok = True
        details = []
        for label, got, exp in checks:
            delta = abs(got - exp)
            worst_delta = max(worst_delta, delta)
            this_tol = tol if label != "freq_max_dev_cm1" else 0.5
            if delta > this_tol:
                ok = False
            details.append(f"{label}: {got:+.9f} (exp {exp:+.9f}, d={delta:.2e})")

        if ok:
            passed += 1
            rows.append((name, "PASS", f"worst d={worst_delta:.2e}", time.time() - t0))
        else:
            failed += 1
            rows.append((name, "FAIL", "; ".join(details), time.time() - t0))
        json_rows.append(
            {
                "name": name,
                "status": "PASS" if ok else "FAIL",
                "worst_delta": worst_delta,
                "seconds": round(time.time() - t0, 2),
                "checks": [
                    {"label": label, "got": float(got), "expected": float(exp)}
                    for label, got, exp in checks
                ],
            }
        )

    print(f"\n{'='*100}")
    for name, status, info, dt in rows:
        mark = {"PASS": "+", "FAIL": "-", "ERROR": "!"}[status]
        print(f" [{mark}] {name:<24} {status:<6} [{dt:6.1f}s] {info}")
    print(f"{'='*100}")
    print(f" {passed} passed, {failed} failed, {errored} errored "
          f"(tolerance {tol:g})")
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(
                {
                    "platform": args.platform,
                    "precision": "f32" if args.f32 else "f64",
                    "tolerance": tol,
                    "passed": passed,
                    "failed": failed,
                    "errored": errored,
                    "cases": json_rows,
                },
                fh,
                indent=1,
            )
        print(f" wrote {args.json_out}")
    return 0 if failed == 0 and errored == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
