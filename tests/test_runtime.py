"""Runtime surroundings: chip_smoke.py's refusal off the GPU and its helpers,
the compile-cache location, and imports without optional packages."""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(extra)
    return env


def test_chip_smoke_refuses_cpu():
    """Off the GPU the smoke run exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "not the GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py it fails and prints no
    result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_result_line():
    import chip_smoke
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev] * 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def test_chip_smoke_log_values(tmp_path):
    import chip_smoke
    log = tmp_path / "train.log"
    log.write_text("[  0]  NLL: 2.30  ACC: 10.00\n[  1]  NLL: 2.10\n")
    assert chip_smoke._log_values(str(log), "NLL:") == [2.30, 2.10]
    log.write_text("[  1]  NLL: nan\n")
    with pytest.raises(RuntimeError, match="not all finite"):
        chip_smoke._log_values(str(log), "NLL:")
    log.write_text("Traceback (most recent call last):\n...\nStopped\n")
    with pytest.raises(RuntimeError, match="failed run"):
        chip_smoke._log_values(str(log), "NLL:")


def test_chip_smoke_parity_phase_small():
    """The parity phase at small shapes on the CPU: the fp32 tiers agree
    with the float64 host references (JAX x64 in worker threads, numpy for
    the CNN)."""
    import chip_smoke
    chip_smoke.phase_parity(n_mlp=32, d=4, n_myrtle=3, n_cnn=6, size=8)


def test_chip_smoke_f64_reference_dtype():
    """The host reference computes in float64 in its worker threads (JAX's
    x64 switch is per thread); a float32 reference would agree with the
    card's float32 result to the bit and prove nothing."""
    import chip_smoke
    from snngp.nn import arch
    kfn = arch.get_mlp_kernel(2, 1, "relu")
    x = np.random.RandomState(0).randn(4, 3)
    out = chip_smoke._f64_on_host(kfn, x, x, rows=2)
    assert out.dtype == np.float64 and out.shape == (4, 4)


@pytest.mark.parametrize("env,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/some/cache"}, "/some/cache"),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, None),
    ({}, os.path.join(REPO, ".jax_cache")),
])
def test_compile_cache_dir(monkeypatch, env, want):
    import snngp
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert snngp.compile_cache_dir() == want


def test_compile_cache_dir_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "/.jax_cache/" in f.read().split()


def test_import_run_without_pandas_or_tqdm():
    code = ("import sys; sys.modules['pandas'] = None; "
            "sys.modules['tqdm'] = None; import run; print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_tqdm_fallback_without_package(monkeypatch):
    from snngp.utils import training
    monkeypatch.setitem(sys.modules, "tqdm", None)
    it = [1, 2, 3]
    assert training.tqdm(it, desc="x") is it
    assert list(training.trange(2, 5)) == [2, 3, 4]


def test_find_table_without_pandas():
    from snngp.cli.find import _format_table
    text = _format_table([[1.0, 2.5], [3.25, 4.0]], [1, 2], [1.0, 3.0])
    lines = text.splitlines()
    assert len(lines) == 3
    assert lines[0].split() == ["1.0", "3.0"]
    assert lines[1].split() == ["1", "1.0000", "2.5000"]
    assert lines[2].split() == ["2", "3.2500", "4.0000"]


def test_gpu_name_and_power_limit_query(monkeypatch):
    from snngp.utils import profiling
    seen = {}

    def fake_run(cmd, **kw):
        seen["cmd"] = cmd
        return types.SimpleNamespace(stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")

    monkeypatch.setattr(profiling.subprocess, "run", fake_run)
    assert profiling.gpu_name_and_power_limit() == \
        "NVIDIA H100 80GB HBM3, 700.00 W"
    assert seen["cmd"] == ["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]


def test_distributed_init_needs_explicit_coordinator(monkeypatch):
    """Only JAX_COORDINATOR_ADDRESS (or explicit arguments) signals a
    multi-process launch; without them init is a no-op."""
    from snngp.parallel import mesh
    called = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: called.append(kw))
    monkeypatch.setattr(mesh, "_DISTRIBUTED_INITIALIZED", False)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    assert mesh.init_distributed() is False and called == []
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:12345")
    assert mesh.init_distributed(num_processes=1, process_id=0) is True
    assert called and called[0]["num_processes"] == 1
