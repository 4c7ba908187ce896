"""chip_smoke.py on the CPU: the rehearsal runs every phase end to end,
and without a GPU, or outside a checkout, the script fails and prints no
result line."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _run(args, cwd=REPO, timeout=600, **extra):
    return subprocess.run(
        [sys.executable] + args, capture_output=True, text=True,
        timeout=timeout, cwd=cwd, env=_env(**extra),
    )


def _last_json(stdout):
    lines = [l for l in stdout.splitlines() if l.strip()]
    return json.loads(lines[-1]) if lines else None


def test_rehearsal_runs_every_phase():
    r = _run([SCRIPT, "--rehearse"])
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    for name in ("device", "ops", "pair", "chain (gpu, multiband)", "serve",
                 "trace"):
        assert f"\n== {name} ==" in r.stdout, name
    assert "FAIL" not in r.stdout
    assert _last_json(r.stdout) == {
        "ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 1}
    }


def test_rehearsal_of_the_four_device_phase():
    r = _run([SCRIPT, "--rehearse", "--chips", "4"])
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "\n== multi-GPU pairs ==" in r.stdout
    assert "\n== ops ==" not in r.stdout      # only the multi-device phase
    assert _last_json(r.stdout)["device"]["count"] == 4


def test_refuses_to_run_without_a_gpu():
    r = _run([SCRIPT], timeout=300)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout


def test_fails_outside_a_checkout(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(SCRIPT, alone / "chip_smoke.py")
    r = _run([str(alone / "chip_smoke.py")], cwd=str(alone), timeout=300,
             PYTHONPATH="")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
