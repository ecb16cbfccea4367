"""chip_smoke.py: its device check, every phase rehearsed on the CPU at a
tiny size through the script's own entry point, and the full-size parity
phases on a card (``gpu`` marker)."""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

import chip_smoke  # noqa: E402


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(jax.devices("cpu"))
    assert e.value.code not in (0, None)


def test_script_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _rehearse(*args, tmp_dir):
    """Run chip_smoke.main in this process; the compile cache goes to a
    temporary directory so the suite's JAX config is left as it was."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_dir))
        with contextlib.redirect_stdout(out):
            rc = chip_smoke.main(["--rehearse", *args])
    return rc, out.getvalue().splitlines()


def _phase_readings(lines, name):
    hit = [ln for ln in lines if ln.startswith(f"phase {name}: ok ")]
    assert hit, f"phase {name} did not pass:\n" + "\n".join(lines)
    return json.loads(hit[0][len(f"phase {name}: ok "):])


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    return _rehearse(tmp_dir=tmp_path_factory.mktemp("cache"))


@pytest.mark.parametrize("phase", ["session", "decoder", "pa", "sift",
                                   "chain"])
def test_rehearse_phase(rehearsal, phase):
    _phase_readings(rehearsal[1], phase)


def test_rehearsal_never_reports_ok(rehearsal):
    rc, lines = rehearsal
    assert rc == 0
    assert any(ln.startswith("nvidia-smi: ") for ln in lines[:-1])
    last = json.loads(lines[-1])
    assert last["rehearsal_passed"] is True and "ok" not in last
    assert last["device"]["platform"] == "cpu"


def test_rehearse_four_cards(tmp_path):
    """The sharded session on the suite's virtual CPU devices: keys, ledgers
    and the psum'd ledger agree with the one-device session."""
    rc, lines = _rehearse("--four-cards", tmp_dir=tmp_path)
    readings = _phase_readings(lines, "four_cards")
    assert rc == 0
    assert readings["keys_equal"] and readings["ledgers_equal"]
    assert readings["psum_windows_checked"] > 0


@pytest.mark.gpu
def test_gpu_decoder_parity_full_width(gpu_device):
    chip_smoke.phase_decoder(chip_smoke.FULL)


@pytest.mark.gpu
def test_gpu_pa_margin_full_width(gpu_device):
    readings = chip_smoke.phase_pa(chip_smoke.FULL)
    assert readings["integer_margin"] < 0.25


@pytest.mark.gpu
def test_gpu_sift_full_width(gpu_device):
    chip_smoke.phase_sift(chip_smoke.FULL)
