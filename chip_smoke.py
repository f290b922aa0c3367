#!/usr/bin/env python3
"""Run the .mqc driver path on NVIDIA GPUs and check it against the CPU.

    python chip_smoke.py          # one GPU: phases 1-6 below
    python chip_smoke.py --four   # four GPUs: the mesh path only

One process drives the card(s). The only other process that runs JAX is
the CPU f64 reference child, which never opens a card.

Phases on one GPU, each printing lines that start with its name:

1. device    JAX devices, the card's name and power limit (nvidia-smi),
             the native host library built from `native/`. Fails unless
             JAX's devices are GPUs.
2. reference The CASES through the same driver on the CPU in f64, in a
             child process that runs while phase 3 works the card: the
             plain reference.
3. gpu       The CASES through `driver.run_file` after the CLI's runtime
             setup: f32 device SCC + f64 host polish. Per case: wall and
             compile time, peak device memory, the device SCC residuals
             (read before the polish replaces them), the host-rescue
             count, and the deltas from phase 2, gated at TOLERANCES,
             RESCUE_MAX_SHARE and DEVICE_FAULT_RESIDUAL.
4. gpu-f64   LEG_CASES with the device in f64 and no polish, gated at
             F64_ENERGY_TOL, timed beside phase 3.
5. gpu-raw   LEG_CASES in raw f32 (no polish): deltas and device SCC
             residuals, not gated.
6. eigh      Batched eigh and SP2-vs-eigh density builds timed on the
             card; the cuSOLVER kernels each eigh runs, read from a
             profiler trace, for plain eigh and for the in-loop eigh of the
             f32 SCC; the count of f64 ops in the compiled f32 SCC.

With --four: LEG_CASES on a 1-D 4-GPU mesh, on a 2-D mesh with
global_groups=2 and on one GPU of the same process, compared with each
other (FOUR_VS_ONE_TOL), with the CPU reference (TOLERANCES), and checked
for 4 shards on 4 distinct GPUs in every dispatched batch.

Any failure makes the script exit non-zero without a result line. The last
line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

import bench
from metalquicha_tpu.runtime import configure_runtime

REPO = os.path.dirname(os.path.abspath(__file__))
INPUTS = os.path.join(REPO, "validation", "inputs")

#: validation inputs of phases 2-3 and what each exercises
CASES = (
    "w20_isomer",          # MBE(4) of 20 waters, 6,195 fragment SCCs
    "gly10",               # capped covalent chain, MBE(2)
    "nlevel_3_ov_decane",  # GMBE(3) / PIE over overlapping fragments
    "prism_hessian",       # FD Hessian over the gradient graph
    "charged_cluster",     # charged fragments
    "w1_water_cpcm",       # CPCM solvation
    "w1_vib_therm",        # GFN2 multipole SCC, frequencies, thermochemistry
)
#: cases of the device-f64, raw-f32 and four-GPU legs
LEG_CASES = ("prism_hessian", "w20_isomer")

#: production leg (f32 device + f64 host polish) vs the CPU f64 reference:
#: the worst production-vs-f64 deviations recorded for the f32+polish path
#: with about one order of margin
TOLERANCES = {
    "energy": 1e-8,      # Ha
    "grad_norm": 1e-7,   # Ha/Bohr
    "hess_norm": 1e-6,   # Ha/Bohr^2 (Frobenius norm)
    "freq_cm1": 1e-2,    # harmonic frequencies, modes above 1 cm^-1
}
#: device f64 vs CPU f64: only the summation order differs
F64_ENERGY_TOL = 1e-9
#: four GPUs vs one GPU, both polished
FOUR_VS_ONE_TOL = 1e-9
#: the host rescue may re-solve at most this share of a case's fragments,
#: and at most this share may end the device SCC above
#: DEVICE_FAULT_RESIDUAL
RESCUE_MAX_SHARE = 0.01
#: f32 SCC residuals end at a floor of about 1e-6 to 1e-4 that straddles
#: the driver's 1e-5 gate (the same f32 SCC on the CPU leaves up to 38% of
#: nlevel_3_ov_decane's fragments above it, worst 7.9e-5), so the share
#: above the gate measures f32 arithmetic and is printed, not gated. A
#: device that computes wrongly leaves residuals far above that floor.
DEVICE_FAULT_RESIDUAL = 1e-3

#: lowering and XLA compilation (tracing nests, so it is left in run_s)
_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)
_compile_s = [0.0]


def _on_duration(event, duration, **_kwargs):
    if event in _COMPILE_EVENTS:
        _compile_s[0] += duration


def require_gpu(devices, count: int) -> None:
    """Raise unless `devices` are `count` or more GPUs: no CPU fallback."""
    platforms = sorted({d.platform for d in devices})
    if platforms != ["gpu"]:
        raise RuntimeError(
            f"no GPU: JAX's devices are {platforms} ({devices})"
        )
    if len(devices) < count:
        raise RuntimeError(f"need {count} GPUs, JAX found {len(devices)}")


def check_executor(ex, devices, dtype) -> None:
    """Raise unless the executor's mesh is exactly `devices` (all GPUs)
    and its calculator runs in `dtype`."""
    mesh_devices = list(ex.mesh.devices.flat)
    require_gpu(mesh_devices, len(devices))
    if set(mesh_devices) != set(devices):
        raise RuntimeError(
            f"executor mesh {mesh_devices} is not the devices {devices}"
        )
    if ex.calc.dtype != dtype:
        raise RuntimeError(
            f"calculator dtype {ex.calc.dtype}, expected {dtype}"
        )


def write_inputs(directory: str, names) -> dict:
    """Validation JSON inputs -> self-contained .mqc files."""
    from metalquicha_tpu.io.prep import emit_mqc

    paths = {}
    for name in names:
        with open(os.path.join(INPUTS, name + ".json")) as fh:
            data = json.load(fh)
        paths[name] = os.path.join(directory, name + ".mqc")
        with open(paths[name], "w") as fh:
            fh.write(emit_mqc(data, base_dir=INPUTS))
    return paths


def observables(out) -> dict:
    r = out.result
    obs = {"energy": float(r.total_energy)}
    if r.gradient is not None:
        obs["grad_norm"] = float(np.linalg.norm(r.gradient))
    if r.hessian is not None:
        obs["hess_norm"] = float(np.linalg.norm(r.hessian))
    if out.vibrational is not None:
        freqs = np.sort(np.asarray(out.vibrational.frequencies))
        obs["freq_cm1"] = [float(f) for f in freqs if abs(f) > 1.0]
    return obs


def deltas(obs: dict, ref: dict) -> dict:
    out = {}
    for key, want in ref.items():
        got = obs[key]
        if key == "freq_cm1":
            if len(got) != len(want):
                out[key] = float("inf")
                continue
            out[key] = max(
                (abs(a - b) for a, b in zip(got, want)), default=0.0
            )
        else:
            out[key] = abs(got - want)
    return out


def _fmt(d: dict) -> str:
    return " ".join(f"d_{k}={v:.3e}" for k, v in d.items())


def run_case(mqc: str, overrides: dict, devices=None, check=None,
             shard_log=None, stats=None):
    """One .mqc through make_executor + driver.run_file.

    check: (devices, dtype) the executor must have (check_executor).
    shard_log: a list that gets, for every dispatched batch, the devices
    holding its shards.
    stats: a dict to fill, also when run_file raises.
    Returns (observables, stats, executor).
    """
    from metalquicha_tpu.driver import make_executor, run_file
    from metalquicha_tpu.io.adapter import config_to_driver
    from metalquicha_tpu.io.config import read_mqc_file

    drv = config_to_driver(read_mqc_file(mqc))
    for key, val in overrides.items():
        setattr(drv, key, val)
    ex = make_executor(drv, devices)
    if check is not None:
        check_executor(ex, *check)
    # the device's own SCC residuals, before any polish or rescue
    residuals = []
    for name in ("energies", "gradients"):
        fn = getattr(ex.calc, name)

        def spied(frag, fn=fn):
            if shard_log is not None:
                shards = frag.coords.addressable_shards
                shard_log.append([s.device for s in shards])
            out = fn(frag)
            residuals.append(np.asarray(out[-1]["scf_residual"]))
            return out

        setattr(ex.calc, name, spied)
    stats = {} if stats is None else stats
    c0 = _compile_s[0]
    t0 = time.perf_counter()
    try:
        outputs = run_file(
            mqc, write_json=False, driver_overrides=overrides, executor=ex
        )
    finally:
        res = np.concatenate(residuals) if residuals else np.zeros(0)
        stats.update(
            wall_s=time.perf_counter() - t0,
            compile_s=_compile_s[0] - c0,
            fragments=ex.n_evaluated,
            device_unconverged=ex.n_device_unconverged,
            device_faulty=int(np.count_nonzero(res > DEVICE_FAULT_RESIDUAL)),
            device_max_residual=float(res.max(initial=0.0)),
            rescued=ex.n_rescued,
        )
    return observables(outputs[""]), stats, ex


def reference_child(names, out_path: str) -> None:
    """Phase 2 body, run in a child with JAX_PLATFORMS=cpu."""
    configure_runtime("cpu")
    import jax

    from metalquicha_tpu.logging_ import global_logger

    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    global_logger.stream = sys.stderr
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, mqc in write_inputs(tmp, names).items():
            obs, stats, _ = run_case(mqc, {})
            results[name] = {"obs": obs, "stats": stats}
    with open(out_path, "w") as fh:
        json.dump(results, fh)


def start_reference(names, tmp: str):
    """Start the CPU f64 reference child; returns (process, out, log)."""
    out = os.path.join(tmp, "reference.json")
    log = os.path.join(tmp, "reference.log")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    code = (
        "import chip_smoke; "
        f"chip_smoke.reference_child({tuple(names)!r}, {out!r})"
    )
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO, env=env,
            stdout=fh, stderr=subprocess.STDOUT,
        )
    return proc, out, log


def wait_reference(proc, out: str, log: str) -> dict:
    t0 = time.perf_counter()
    rc = proc.wait()
    if rc != 0:
        with open(log) as fh:
            tail = fh.read()[-4000:]
        raise RuntimeError(f"CPU reference child failed (rc={rc}):\n{tail}")
    with open(out) as fh:
        ref = json.load(fh)
    for name, r in ref.items():
        st = r["stats"]
        print(
            f"reference {name}: energy={r['obs']['energy']:.12f} "
            f"{_timing(st)} fragments={st['fragments']}"
        )
    print(f"reference: waited {time.perf_counter() - t0:.3f} s for the child")
    return {name: r["obs"] for name, r in ref.items()}


def expected_deltas(ref: dict) -> None:
    """Reference vs validation/expected.json, for information only."""
    with open(os.path.join(REPO, "validation", "expected.json")) as fh:
        tests = json.load(fh)["tests"]
    by_input = {t["input"]: t for t in tests}
    for name, obs in ref.items():
        t = by_input.get(name + ".json")
        if t is not None and "energy" in t:
            print(
                f"reference {name}: vs expected.json "
                f"d_energy={abs(obs['energy'] - t['energy']):.3e} "
                f"(information only)"
            )


def peak_bytes(devices) -> list[int]:
    return [d.memory_stats()["peak_bytes_in_use"] for d in devices]


def phase_device(count: int):
    import jax

    devices = jax.devices()
    print(f"device: jax.devices()={devices}")
    require_gpu(devices, count)
    print(
        f"device: platform={devices[0].platform} "
        f"device_kind={devices[0].device_kind} count={len(devices)}"
    )
    cache = jax.config.jax_compilation_cache_dir
    n_entries = len(os.listdir(cache)) if cache and os.path.isdir(cache) else 0
    print(f"device: compile cache {cache} holds {n_entries} entries at start")
    print("device: nvidia-smi name, power.limit:")
    for line in bench.card_info():
        print(line)
    subprocess.run(
        ["make", "-C", os.path.join(REPO, "native")],
        check=True, capture_output=True, text=True,
    )
    from metalquicha_tpu import native

    print(f"device: native/libmqc_host.so loaded={native.available()}")
    return devices


def gate(failures: list, what: str, value: float, limit: float) -> str:
    ok = value <= limit
    if not ok:
        failures.append(f"{what}: {value:.3e} > {limit:.1e}")
    return "ok" if ok else "FAIL"


def _scc(st: dict) -> str:
    """The device SCC's residuals and the host rescue of one run."""
    return (
        f"fragments={st['fragments']} device SCC above the driver's gate "
        f"{st['device_unconverged']}, above {DEVICE_FAULT_RESIDUAL:.0e} "
        f"{st['device_faulty']}, max residual "
        f"{st['device_max_residual']:.3e}; rescued={st['rescued']}"
    )


def gate_scc(failures: list, what: str, st: dict) -> list:
    n = max(1, st["fragments"])
    return [
        gate(failures, f"{what} rescue share", st["rescued"] / n,
             RESCUE_MAX_SHARE),
        gate(failures, f"{what} device fault share",
             st["device_faulty"] / n, RESCUE_MAX_SHARE),
    ]


def _timing(st: dict) -> str:
    """wall time, the compile time inside it, and the rest (run_s)."""
    return (
        f"wall_s={st['wall_s']:.3f} compile_s={st['compile_s']:.3f} "
        f"run_s={st['wall_s'] - st['compile_s']:.3f}"
    )


def phase_gpu(mqcs, devices, failures) -> dict:
    import jax.numpy as jnp

    results = {}
    for name in CASES:
        obs, st, _ = run_case(
            mqcs[name], {}, devices, check=(devices, jnp.float32)
        )
        results[name] = obs, st
        verdicts = gate_scc(failures, f"gpu {name}", st)
        print(
            f"gpu {name}: {_timing(st)} "
            f"peak_bytes_in_use={peak_bytes(devices)[0]} {_scc(st)} "
            f"{verdicts}"
        )
    return results


def compare_gpu(results, ref, failures) -> None:
    for name, (obs, _) in results.items():
        d = deltas(obs, ref[name])
        verdicts = [
            gate(failures, f"gpu {name} {k}", v, TOLERANCES[k])
            for k, v in d.items()
        ]
        print(f"gpu {name}: vs cpu-f64 {_fmt(d)} {verdicts}")


def phase_f64(mqcs, devices, ref, results, failures) -> None:
    import jax.numpy as jnp

    for name in LEG_CASES:
        obs, st, _ = run_case(
            mqcs[name], {"force_dtype": "f64", "host_polish": "off"},
            devices, check=(devices, jnp.float64),
        )
        d = deltas(obs, ref[name])
        verdict = gate(
            failures, f"gpu-f64 {name} energy", d["energy"], F64_ENERGY_TOL
        )
        print(
            f"gpu-f64 {name}: {_timing(st)} "
            f"(f32+polish {_timing(results[name][1])}) "
            f"peak_bytes_in_use={peak_bytes(devices)[0]} "
            f"vs cpu-f64 {_fmt(d)} [{verdict}]"
        )


def phase_raw(mqcs, devices, ref) -> None:
    import jax.numpy as jnp

    from metalquicha_tpu.errors import ConvergenceError

    for name in LEG_CASES:
        # raw f32 may miss the driver's own SCC convergence gate, which
        # then refuses the run: that refusal is this ungated leg's result.
        # The production leg's device SCC is the same computation; its
        # residuals are the ones phase gpu prints before the polish.
        st = {}
        try:
            obs, st, _ = run_case(
                mqcs[name], {"host_polish": "off"},
                devices, check=(devices, jnp.float32), stats=st,
            )
        except ConvergenceError as exc:
            print(f"gpu-raw {name}: refused by the driver: {exc}; "
                  f"{_scc(st)} (not gated)")
            continue
        print(
            f"gpu-raw {name}: {_timing(st)} vs cpu-f64 "
            f"{_fmt(deltas(obs, ref[name]))}; {_scc(st)} (not gated)"
        )


def device_kernels(fn, *args, trace_dir: str) -> list:
    """[(kernel name, total ns, count)] of the GPU events of one traced
    call of fn(*args), longest first. fn must be compiled already."""
    import jax

    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(fn(*args))
    path = max(
        glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                  recursive=True),
        key=os.path.getmtime,
    )
    totals = {}
    profile = jax.profiler.ProfileData.from_file(path)
    for plane in profile.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        # kernels sit on the stream lines; the op and module lines repeat
        # them under XLA's names
        lines = [ln for ln in plane.lines if "Stream" in ln.name]
        for line in lines or plane.lines:
            for ev in line.events:
                ns, n = totals.get(ev.name, (0.0, 0))
                totals[ev.name] = (ns + ev.duration_ns, n + 1)
    if not totals:
        raise RuntimeError(f"no GPU events in the trace {path}")
    return sorted(
        ((k, ns, n) for k, (ns, n) in totals.items()), key=lambda t: -t[1]
    )


def solver_routine(kernels) -> str:
    """Which cuSOLVER path the kernel names show."""
    names = " ".join(k.lower() for k, _, _ in kernels)
    found = [
        label for label, keys in (
            ("syevj (Jacobi)", ("syevj", "jacobi")),
            ("syevd (tridiagonal + divide and conquer)",
             ("sytrd", "stedc", "ormtr", "syevd", "latrd", "steqr")),
        )
        if any(k in names for k in keys)
    ]
    return " + ".join(found) or "unrecognised"


def _water_cluster_batch(calc, n_waters: int, batch: int, seed: int = 0):
    """`batch` random n-water clusters on a 3 Angstrom grid line."""
    from metalquicha_tpu.constants import ANGSTROM_TO_BOHR

    w = np.array(
        [[0.0, 0.0, 0.117], [0.0, 0.757, -0.471], [0.0, -0.757, -0.471]]
    ) * ANGSTROM_TO_BOHR
    rng = np.random.default_rng(seed)
    frags = []
    for _ in range(batch):
        coords = np.vstack([
            w + rng.normal(0, 0.05, (1, 3))
            + np.array([[3.0 * ANGSTROM_TO_BOHR * k, 0, 0]])
            for k in range(n_waters)
        ])
        frags.append((np.tile([8, 1, 1], n_waters), coords, 0, 1))
    return calc.make_batch(frags)


def phase_eigh(trace_root: str) -> None:
    import jax
    import jax.numpy as jnp

    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator

    for nmat, n in ((512, 16), (128, 64)):
        secs = bench.eigh_secs(nmat, n)
        a = np.random.default_rng(1).normal(size=(nmat, n, n))
        a = jnp.asarray((a + a.transpose(0, 2, 1)).astype(np.float32))
        eigh = jax.jit(jnp.linalg.eigh)
        eigh(a)[1].block_until_ready()
        kernels = device_kernels(
            eigh, a, trace_dir=os.path.join(trace_root, f"eigh_{nmat}_{n}")
        )
        print(
            f"eigh ({nmat}, {n}) f32: {secs * 1e3:.4f} ms/call, cuSOLVER "
            f"{solver_routine(kernels)}; kernels "
            f"{[(k[:60], round(ns / 1e3, 1), c) for k, ns, c in kernels[:4]]}"
        )
    for nmat, n in ((64, 128), (64, 256)):
        sp2 = bench.density_secs(nmat, n, "sp2")
        eig = bench.density_secs(nmat, n, "eigh")
        print(
            f"eigh density ({nmat}, {n}) f32: sp2 {sp2 * 1e3:.4f} ms, "
            f"eigh {eig * 1e3:.4f} ms, eigh/sp2 {eig / sp2:.3f}"
        )
    # the in-loop eigh of the f32 SCC (vmap inside the SCC while_loop) at
    # AO widths 32 (w20's tetramer bucket), 64 and 128
    calc = XtbCalculator(dtype=jnp.float32)
    energies, _ = calc._compiled(calc.settings)
    for n_waters in (4, 8, 16):
        frag = _water_cluster_batch(calc, n_waters, 64)
        nao = frag.ao_mask.shape[-1]
        compiled = energies.lower(frag.coords, frag).compile()
        n_f64 = len(re.findall(r"= f64\[", compiled.as_text()))
        compiled(frag.coords, frag)[0].block_until_ready()
        kernels = device_kernels(
            compiled, frag.coords, frag,
            trace_dir=os.path.join(trace_root, f"scc_{n_waters}"),
        )
        solver = [k for k in kernels if solver_routine([k]) != "unrecognised"]
        print(
            f"eigh in-loop f32 SCC (64 x {n_waters} waters, nao={nao}): "
            f"cuSOLVER {solver_routine(solver)}; f64 ops in compiled HLO "
            f"{n_f64}; top kernels "
            f"{[(k[:60], round(ns / 1e3, 1), c) for k, ns, c in kernels[:4]]}"
        )


def main_one() -> dict:
    import jax

    devices = phase_device(1)[:1]
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        mqcs = write_inputs(tmp, CASES)
        child = start_reference(CASES, tmp)
        print(f"reference: CPU f64 child on {len(CASES)} cases, running "
              f"beside phase gpu")
        try:
            results = phase_gpu(mqcs, devices, failures)
            ref = wait_reference(*child)
        finally:
            _stop(child[0])
        expected_deltas(ref)
        compare_gpu(results, ref, failures)
        phase_f64(mqcs, devices, ref, results, failures)
        phase_raw(mqcs, devices, ref)
        phase_eigh(os.path.join(tmp, "trace"))
    return finish(failures)


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def main_four() -> dict:
    import jax
    import jax.numpy as jnp

    devices = phase_device(4)[:4]
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        mqcs = write_inputs(tmp, LEG_CASES)
        child = start_reference(LEG_CASES, tmp)
        print(f"reference: CPU f64 child on {len(LEG_CASES)} cases "
              f"(runs while the GPUs work)")
        try:
            results = {}
            for name in LEG_CASES:
                for label, over, devs in (
                    ("4-GPU 1-D", {}, devices),
                    ("4-GPU 2-D", {"global_groups": 2}, devices),
                    ("1-GPU", {}, devices[:1]),
                ):
                    shards = []
                    obs, st, ex = run_case(
                        mqcs[name], over, devs,
                        check=(devs, jnp.float32), shard_log=shards,
                    )
                    results[name, label] = obs
                    layouts = {(len(s), len(set(s))) for s in shards}
                    verdicts = gate_scc(failures, f"four {name} {label}", st)
                    print(
                        f"four {name} {label}: mesh={dict(ex.mesh.shape)} "
                        f"{_timing(st)} "
                        f"batches={len(shards)} (shards, distinct devices) "
                        f"per batch={sorted(layouts)} {_scc(st)} {verdicts}"
                    )
                    if len(devs) == 4:
                        on_gpus = all(
                            d in devices for s in shards for d in s
                        )
                        if layouts != {(4, 4)} or not on_gpus:
                            failures.append(
                                f"four {name} {label}: batches not on 4 "
                                f"distinct GPUs ({sorted(layouts)})"
                            )
                for label in ("4-GPU 1-D", "4-GPU 2-D"):
                    d = deltas(results[name, label], results[name, "1-GPU"])
                    verdict = gate(
                        failures, f"four {name} {label} vs 1-GPU energy",
                        d["energy"], FOUR_VS_ONE_TOL,
                    )
                    print(f"four {name} {label} vs 1-GPU: {_fmt(d)} "
                          f"[{verdict}]")
            ref = wait_reference(*child)
        finally:
            _stop(child[0])
        for name in LEG_CASES:
            for label in ("4-GPU 1-D", "4-GPU 2-D", "1-GPU"):
                d = deltas(results[name, label], ref[name])
                verdicts = [
                    gate(failures, f"four {name} {label} {k}", v,
                         TOLERANCES[k])
                    for k, v in d.items()
                ]
                print(f"four {name} {label} vs cpu-f64: {_fmt(d)} "
                      f"{verdicts}")
        print(f"four: peak_bytes_in_use per card {peak_bytes(devices)}")
    return finish(failures)


def finish(failures) -> dict:
    import jax

    if failures:
        for f in failures:
            print(f"FAILED {f}")
        raise SystemExit(1)
    devices = jax.devices()
    return {
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh path")
    args = ap.parse_args(argv)

    configure_runtime()
    import jax

    from metalquicha_tpu.logging_ import global_logger

    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    # keep stdout to the phase lines and the result line
    global_logger.stream = sys.stderr
    result = main_four() if args.four else main_one()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
