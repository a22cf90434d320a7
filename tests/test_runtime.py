"""Runtime plumbing that needs no card: the compile-cache helper, the device
guard of bench.py, and chip_smoke.py's phase selection and refusals."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import bench
import chip_smoke
from stfem_tpu.utils import runtime

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them (a real
    cache directory would leak into every later test of the worker)."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_compile_cache_honours_env(monkeypatch, tmp_path, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.configure_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in dict(config_updates)


def test_compile_cache_default_in_checkout(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.configure_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert dict(config_updates)["jax_compilation_cache_dir"] == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(runtime.NoAcceleratorError):
        runtime.require_gpu()


def test_bench_refuses_to_time_on_cpu(monkeypatch, config_updates):
    """Without --rehearse no section runs off a GPU."""
    def must_not_run(*a, **k):
        raise AssertionError("a section ran on the CPU")

    monkeypatch.setattr(bench, "SECTIONS",
                        {k: must_not_run for k in bench.SECTIONS})
    with pytest.raises(runtime.NoAcceleratorError):
        bench.main([])
    with pytest.raises(runtime.NoAcceleratorError):
        bench.run_sections(["heat"])


def test_bench_rehearsal_drops_device_numbers(monkeypatch):
    """A rehearsal runs at the tiny sizes and strips every time and rate."""
    seen = {}

    def fake(name):
        def run(host, dev, **kw):
            seen[name] = kw
            return {"section": name, "converged": True, "dofs_per_s": 1.0,
                    "solve_s": 1.0, "compile_s": 1.0, "setup_s": 1.0}
        return run

    monkeypatch.setattr(bench, "SECTIONS",
                        {k: fake(k) for k in bench.SECTIONS})
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    out = bench.run_sections(["heat", "wave"], rehearse=True)
    assert seen == {"heat": bench.REHEARSAL["heat"],
                    "wave": bench.REHEARSAL["wave"]}
    for r in out:
        assert r["platform"] == "cpu" and r["device_count"] >= 1
        assert not set(bench.DEVICE_KEYS) & set(r)
        assert r["setup_s"] == 1.0


@pytest.mark.parametrize("multichip,phases", [
    (None, ("device", "parity", "heat", "stokes_wave", "driver")),
    (4, ("device", "multichip")),
])
def test_chip_smoke_phase_selection(multichip, phases):
    assert chip_smoke.select_phases(multichip) == phases
    assert set(phases) <= set(chip_smoke.PHASES)


def test_chip_smoke_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 2
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_outside_checkout(tmp_path):
    """Alone in a directory the script finds none of the repository and
    fails without printing a result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_driver_config_is_the_pinned_case(tmp_path):
    """The driver phase's config is the 2D heat DG(1), 2-steps-at-once,
    refinement-2 case that test_heat_endtoend pins to 1.78760e-02."""
    import json

    from stfem_tpu.config import Parameters
    from stfem_tpu.types import ProblemType, TimeStepType

    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(chip_smoke.DRIVER_CONFIG))
    p = Parameters.parse(str(path), 2)
    assert (p.problem, p.type) == (ProblemType.heat, TimeStepType.DG)
    assert (p.fe_degree, p.n_timesteps_at_once, p.refinement) == (1, 2, 2)
    assert (p.n_deg_cycles, p.n_ref_cycles) == (1, 1)
    assert p.space_time_conv_test and p.space_time_mg
    assert chip_smoke.GOLDEN_L2_DG1_REF2 == 1.78760e-02
