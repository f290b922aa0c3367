"""Process-wide JAX setup shared by every entry point.

The CLI, the validation runner, `bench.py` and `chip_smoke.py` all call
`configure_runtime` before their first JAX computation.
"""

from __future__ import annotations

import os


def configure_runtime(platform: str | None = None) -> None:
    """Platforms, x64, matmul precision and the compile cache.

    platform: a `jax_platforms` value ("cpu", "cuda", ...); None keeps
    `JAX_PLATFORMS` or, if that is unset, JAX's own choice. A CPU backend
    is always kept next to an accelerator: the f64 polish of f32 device
    results runs there (methods/xtb/polish.py).
    """
    import jax

    from .compile_cache import enable

    enable()
    plats = platform or os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        plats += ",cpu"
    if plats:
        jax.config.update("jax_platforms", plats)
    # x64 is always on; the device working dtype is explicit per backend
    # (methods/factory.py), so this only enables the host-side f64 math
    jax.config.update("jax_enable_x64", True)
    # keep f32 products in full f32: on the GPU the default lets them run
    # in TF32, whose ~3 decimal digits are far short of the SCC tolerance
    jax.config.update("jax_default_matmul_precision", "highest")
