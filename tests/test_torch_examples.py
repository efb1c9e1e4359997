"""The port's examples (`examples/*_torch.py`) run on the CPU at a small
size: each exits 0 after checking every answer against the port's brute
force (`repro_torch.core.search`), within 120 s, and none imports jax or
the JAX package (`repro`).  Each runs in a fresh interpreter with `src`
on its path, as a user runs it from the repository root."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

# the example, its CPU arguments, the line that says it checked itself
EXAMPLES = {
    "quickstart_torch": (["--device", "cpu", "--series", "60"],
                         "quickstart OK"),
    "dedup_pipeline_torch": (["--device", "cpu", "--series", "60"],
                             "dedup OK"),
    "serve_ulisse_torch": (["--device", "cpu", "--devices", "1", "--series",
                            "64", "--queries", "9"], "serve OK"),
}

# runs the example as __main__, then fails if jax or repro was imported
RUNNER = (
    "import runpy, sys\n"
    "path = sys.argv[1]\n"
    "sys.argv = sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_path(path, run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    if e.code not in (0, None):\n"
    "        raise\n"
    "bad = sorted(n for n in sys.modules\n"
    "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
    "assert not bad, bad\n"
    "print('imports OK')\n")


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_checks_itself_on_the_cpu(name):
    args, ok_line = EXAMPLES[name]
    # one torch thread: the tier-1 run has six workers on the same cores,
    # and the plain DP's small per-diagonal ops on torch's default pool
    # oversubscribe them (as the other port tests cap their threads)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", RUNNER, str(ROOT / "examples" / f"{name}.py"),
         *args], capture_output=True, text=True, env=env, timeout=120,
        cwd=str(ROOT))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert ok_line in out.stdout
    assert "imports OK" in out.stdout
    assert "MISMATCH" not in out.stdout


def test_example_fails_on_a_mismatch(monkeypatch, capsys):
    """An answer that disagrees with the brute force makes the example
    exit with status 1."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import dedup_pipeline_torch as ex
    finally:
        sys.path.pop(0)
    from repro_torch.core import UlisseEngine
    real = UlisseEngine.search

    def off_by_one(self, q, spec=None):
        res = real(self, q, spec)
        res.dists[0] += 1.0
        return res
    monkeypatch.setattr(UlisseEngine, "search", off_by_one)
    assert ex.main(["--device", "cpu", "--series", "12"]) == 1
    assert "MISMATCH" in capsys.readouterr().out
