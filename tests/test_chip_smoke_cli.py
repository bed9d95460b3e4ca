"""chip_smoke.py and __graft_entry__ as commands on the CPU: the device
check, a copy outside the repo, and the main path with the optional
interop packages blocked (the GPU machine does not have them)."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTIONAL = ("pyarrow", "pandas", "zstandard", "grpc", "cryptography",
            "flatbuffers")


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **extra)
    return env


def _run(args, cwd=REPO, env=None, timeout=600):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          env=env or _env(), capture_output=True,
                          text=True, timeout=timeout)


def test_refuses_cpu_without_rehearse():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "expected platform 'gpu'" in r.stderr


def test_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _env()
    env.pop("PYTHONPATH")
    r = _run(["chip_smoke.py", "--rehearse"], cwd=tmp_path, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


_BLOCK = ("import sys\n"
          f"for m in {OPTIONAL!r}:\n"
          "    sys.modules[m] = None\n")


def test_main_path_without_optional_packages():
    """import, numpy ingest, TPC-H Q1/Q3/Q6 through a1t.query and a
    compiled pipeline, with the interop packages unimportable."""
    code = _BLOCK + (
        "import chip_smoke, arrow1_tpu\n"
        "chip_smoke.phase_tpch(chip_smoke.REHEARSE, 1)\n"
        "chip_smoke.phase_pipeline(chip_smoke.REHEARSE, 1)\n"
        f"bad = [m for m in {OPTIONAL!r} if sys.modules.get(m)]\n"
        "assert not bad, bad\n"
        "print('NO_OPTIONAL_OK')\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_OPTIONAL_OK" in r.stdout
    assert r.stdout.count("PHASE ") == 5


def test_dryrun_multichip_without_optional_packages():
    code = _BLOCK + ("import __graft_entry__ as g\n"
                     "g.dryrun_multichip(4)\n")
    r = _run(["-c", code], env=_env(
        XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "dryrun_multichip(4): OK" in r.stdout


def test_dryrun_multichip_refuses_too_few_devices():
    code = "import __graft_entry__ as g\ng.dryrun_multichip(4)\n"
    r = _run(["-c", code])
    assert r.returncode != 0
    assert "need 4 devices" in r.stderr
