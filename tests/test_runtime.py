"""Runtime setup, device checks and the executor's padding.

What the GPU path depends on but the CPU can check: the compile-cache
directory rule, the GPU gate of chip_smoke.py (no CPU fallback), the
executor's device-count padding, and the accelerator dtype/polish wiring.
"""

import os

import numpy as np
import pytest

from test_driver import TWO_WATERS_MQC
from test_polish import _water_frags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [True, False], ids=["env", "default"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, enable() sets no directory;
    without it, the cache lives at <repo>/.jax_cache."""
    import jax

    from metalquicha_tpu import compile_cache

    before = jax.config.jax_compilation_cache_dir
    preset = str(tmp_path / "preset")
    jax.config.update("jax_compilation_cache_dir", preset)
    try:
        if env_dir:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        compile_cache.enable()
        got = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    if env_dir:
        assert got == preset
    else:
        assert got == os.path.join(REPO, ".jax_cache")
        assert os.path.isdir(got)


def test_chip_smoke_refuses_cpu_devices():
    """The smoke's GPU gate raises on CPU devices and on an executor whose
    mesh is on the CPU: there is no CPU fallback."""
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu.parallel.executor import FragmentExecutor

    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu(jax.devices(), 1)
    ex = FragmentExecutor(XtbCalculator(dtype=jnp.float32))
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_executor(ex, jax.devices(), jnp.float32)


def test_executor_pads_to_device_multiple_only(monkeypatch):
    """On the 8-device mesh a 5-fragment bucket is padded to 8 and no
    further; the padding does not change any result."""
    import jax

    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator
    from metalquicha_tpu.parallel.executor import FragmentExecutor
    from metalquicha_tpu.parallel.mesh import fragment_mesh

    sizes = []
    make_batch = XtbCalculator.make_batch

    def spy(self, fragments, pad_to=None):
        sizes.append(len(fragments))
        return make_batch(self, fragments, pad_to=pad_to)

    monkeypatch.setattr(XtbCalculator, "make_batch", spy)
    frags = _water_frags(5)
    assert len(jax.devices()) == 8
    e8, _ = FragmentExecutor().run(frags, what="energy")
    assert sizes == [8]
    ex1 = FragmentExecutor(mesh=fragment_mesh(jax.devices()[:1]))
    e1, _ = ex1.run(frags, what="energy")
    assert sizes == [8, 5]
    np.testing.assert_allclose(e8, e1, rtol=0, atol=1e-13)


def test_accelerator_backend_runs_f32_with_polish(monkeypatch):
    """On a GPU backend the factory picks f32 and the driver wires the
    f64 host polisher and the rescue gate."""
    import jax
    import jax.numpy as jnp

    from metalquicha_tpu.driver import make_executor
    from metalquicha_tpu.io.adapter import config_to_driver
    from metalquicha_tpu.io.config import parse_mqc_string
    from metalquicha_tpu.methods.factory import create_calculator
    from metalquicha_tpu.methods.xtb.polish import HostPolisher

    drv = config_to_driver(
        parse_mqc_string(TWO_WATERS_MQC.format(driver="Energy"))
    )
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert create_calculator(drv).dtype == jnp.float32
    ex = make_executor(drv)
    assert ex.calc.dtype == jnp.float32
    assert isinstance(ex.polisher, HostPolisher)
    assert ex.polisher.calc64.dtype == jnp.float64
    assert ex.rescue_tol == max(10.0 * drv.method.scf.tolerance, 1e-8)


@pytest.mark.parametrize("variant", ["gfn1", "gfn2"])
def test_f32_graph_has_no_f64_ops(variant):
    """With x64 on, the compiled f32 energy+gradient graph holds no f64
    op: an undtyped constant array would promote its expression to f64,
    which a GPU runs at a fraction of the f32 rate."""
    import re

    import jax.numpy as jnp

    from metalquicha_tpu.methods.xtb.calculator import XtbCalculator

    calc = XtbCalculator(dtype=jnp.float32, variant=variant)
    frag = calc.make_batch(_water_frags(2))
    _, grad_fn = calc._compiled(calc.settings)
    hlo = grad_fn.lower(frag.coords, frag).compile().as_text()
    assert re.findall(r"= f64\[", hlo) == []
