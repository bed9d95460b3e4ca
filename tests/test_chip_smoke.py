"""chip_smoke.py phases on the CPU at rehearsal size, and compile-cache
placement. The command-line checks are in test_chip_smoke_cli.py."""

import os

import pytest

import chip_smoke
from arrow1_tpu import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("phase", chip_smoke.SINGLE_PHASES,
                         ids=lambda p: p.__name__)
def test_single_card_phase_rehearsal(phase, capsys):
    phase(chip_smoke.REHEARSE, 0)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("PHASE ")]
    assert lines, "phase printed no PHASE line"


def test_distributed_phase_rehearsal_four_devices(capsys):
    from arrow1_tpu.parallel import make_mesh

    chip_smoke.phase_distributed(chip_smoke.REHEARSE, 0, make_mesh(4))
    out = capsys.readouterr().out
    assert "'l_orderkey': 4" in out          # shards really on 4 devices
    assert out.count("PHASE ") == 4


def test_compile_cache_default_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(config.jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    want = os.path.join(REPO, ".jax_cache")
    assert config.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]


def test_compile_cache_env_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(config.jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert config.enable_compile_cache() == str(tmp_path)
    assert calls == []          # JAX reads the variable itself
