"""Runtime plumbing that decides where and how the program runs: the compile
cache helper, the backend rule, the smoke script's device contract, the
Gram block evaluator, and the precision of every f32 dot on the GPU path
(a lowering audit: no f32 result may depend on the GPU's TF32 default)."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nonlinpdes_gpsolver as gpt
from nonlinpdes_gpsolver.ops import backend
from nonlinpdes_gpsolver.utils import config

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/cache"])
def test_setup_compile_cache(monkeypatch, env_dir):
    """The env var wins and no directory is set in code; otherwise the
    fixed in-checkout ``.jax_cache`` (never a temporary or per-run name)."""
    updates = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.append((k, v)))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = config.setup_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert updates == [("jax_compilation_cache_dir", path)]
        assert config.setup_compile_cache() == path  # fixed across calls
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert config.setup_compile_cache() == env_dir
        assert updates == []


@pytest.mark.parametrize("x64", [None, True, False])
def test_setup_runtime_sets_precision_then_cache(monkeypatch, x64):
    """One helper sets every entry point's precision (f64 unless asked) and
    its compile cache; the example drivers reach it through apply_runtime."""
    updates = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.append((k, v)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    if x64 is None:
        path = config.setup_runtime()
        want = config.DEFAULT_X64
    else:
        config.apply_runtime(config.SolverConfig(x64=x64))
        path = str(REPO / ".jax_cache")
        want = x64
    assert config.DEFAULT_X64 is True and config.SolverConfig().x64 is True
    assert updates == [("jax_enable_x64", want),
                       ("jax_compilation_cache_dir", path)]


def test_old_import_name_is_an_alias():
    """The package's earlier name (the alias package beside it) resolves to
    the very same module objects, submodules included."""
    import importlib

    olds = [p.name for p in REPO.iterdir()
            if p.name.startswith(gpt.__name__ + "_") and (p / "__init__.py").exists()]
    assert len(olds) == 1
    assert importlib.import_module(olds[0]) is gpt
    assert importlib.import_module(olds[0] + ".ops.backend") is backend
    mod = importlib.import_module(olds[0] + ".solvers.distributed")
    assert mod.factorize_distributed is gpt.solvers.distributed.factorize_distributed


@pytest.mark.parametrize(
    "platform,expected", [("gpu", True), ("cpu", False), ("rocm", None), ("metal", None)]
)
def test_is_accelerator(monkeypatch, platform, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if expected is None:
        with pytest.raises(RuntimeError, match="unsupported JAX platform"):
            backend.is_accelerator()
    else:
        assert backend.is_accelerator() is expected


def _import_chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def test_chip_smoke_device_check_fails_on_cpu():
    cs = _import_chip_smoke()
    with pytest.raises(SystemExit) as exc:
        cs.require_gpu()
    assert exc.value.code not in (0, None)


def test_chip_smoke_contract_line():
    cs = _import_chip_smoke()

    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = cs.contract_line([Dev()] * 4)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4},
    }


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_points_fail_without_gpu(tmp_path, script):
    """On a machine with no GPU both entry points exit non-zero and print no
    result - the smoke script also when it stands alone, without the
    package beside it."""
    if script == "chip_smoke.py":
        (tmp_path / script).write_text((REPO / script).read_text())
        cwd = tmp_path
    else:
        cwd = REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"metric"' not in proc.stdout


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("pair", ["lap-lap", "lap-id", "dx-dyy"])
def test_pair_impl_is_pair_fn(dtype, pair):
    from nonlinpdes_gpsolver.ops.assembly import _pair_impl

    ops = {"lap": gpt.laplacian(), "id": gpt.identity(), "dx": gpt.d(0),
           "dyy": gpt.d2(1, 1)}
    ox, oy = (ops[k] for k in pair.split("-"))
    k = gpt.SquaredExponential.anisotropic([0.3, 0.05])
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.uniform(0, 1, (37, 2)), dtype)
    Y = jnp.asarray(rng.uniform(0, 1, (23, 2)), dtype)
    got = _pair_impl(k, ox, oy)(X, Y)
    assert got.dtype == dtype and got.shape == (37, 23)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(k.pair_fn(ox, oy)(X, Y)))


_DOT = re.compile(r"stablehlo\.dot_general .*?precision = \[(\w+), (\w+)\].*?: \((.*?)\) ->")


def _f32_dots(dump_dir):
    """(precisions, operand types) of every f32 dot_general in the dumped
    modules; a dot with no precision attribute runs at DEFAULT."""
    out = []
    for f in Path(dump_dir).glob("*.mlir"):
        for line in f.read_text().splitlines():
            if "stablehlo.dot_general" not in line:
                continue
            m = _DOT.search(line)
            if m is None:  # no precision_config at all: DEFAULT
                types = line.split(": (")[-1]
                if "f32>" in types:
                    out.append(("DEFAULT", "DEFAULT", types))
                continue
            if "f32>" in m.group(3):
                out.append(m.groups())
    return out


@pytest.mark.parametrize("path", ["dense", "fused"])
def test_gpu_path_f32_dots_are_highest(monkeypatch, tmp_path, path):
    """Lower the GPU path at f32 (backend rule patched to 'GPU') and audit
    every f32 dot_general XLA is given: all must carry HIGHEST, so none can
    run in TF32. Covers the dense factorize + GN step and the fused
    streaming factorization + its GN step."""
    monkeypatch.setattr(backend, "is_accelerator", lambda: True)
    # shapes unique to this test, so every executable is lowered afresh
    N, Nb = (53, 19) if path == "dense" else (61, 23)
    Xd, Xb = gpt.utils.sample_random(jax.random.PRNGKey(4), N, Nb)
    Xd, Xb = Xd.astype(jnp.float32), Xb.astype(jnp.float32)

    def u(x):
        return jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1])

    def rhs(x):
        return -jnp.trace(jax.hessian(u)(x)) + u(x) ** 3

    prob = gpt.models.nonlinear_elliptic(
        gpt.SquaredExponential.gaussian(0.3), Xd, Xb, rhs, u, seed=3
    )
    prev = jax.config.read("jax_dump_ir_to")
    jax.config.update("jax_dump_ir_to", str(tmp_path))
    try:
        if path == "dense":
            fp = gpt.factorize(prob, nugget=1e-5, dtype=jnp.float32)
            st = gpt.gn_solve(fp, max_iter=1)
        else:
            from nonlinpdes_gpsolver.parallel import make_mesh
            from nonlinpdes_gpsolver.solvers.distributed import (
                factorize_distributed, gn_solve_distributed,
            )

            fp = factorize_distributed(prob, make_mesh(1), nugget=1e-5, block=16,
                                       superblock_cols=32)
            st = gn_solve_distributed(fp, max_iter=1, step_solver="cg")
        assert st.z.dtype == jnp.float32
        jax.block_until_ready(st.z)
    finally:
        jax.config.update("jax_dump_ir_to", prev)
    dots = _f32_dots(tmp_path)
    ranked = [d for d in dots if re.search(r"tensor<\d+x\d+", d[2])]
    assert len(ranked) >= 5, f"audit saw too few rank>=2 f32 dots: {dots}"
    bad = [d for d in dots if d[:2] != ("HIGHEST", "HIGHEST")]
    assert not bad, f"f32 dot_general below HIGHEST precision: {bad[:5]}"
