"""``examples/paper_repro_torch.py`` on the CPU, in a fresh interpreter
bounded by its own timeout: the paper API round trip, the three
strategies' ResNet smoke runs (the same losses: identical math, another
schedule) and the paper-era figure tables with the paper's claims; and
no module of JAX or of the JAX package is loaded on the way."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "paper_repro_torch.py")


def test_paper_repro_runs_on_the_cpu_without_jax():
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{EXAMPLE!r}, '--device', 'cpu']\n"
        f"runpy.run_path({EXAMPLE!r}, run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('loaded', bad)\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "PYTHONPATH")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert "[paper-api] KVStore DepCha push/pull roundtrip: OK" in out
    losses = [line.split("loss ")[1] for line in out.splitlines()
              if line.startswith("[cifar]")]
    assert len(losses) == 3 and len(set(losses)) == 1, out
    assert "[fig14] ImageNet Inception-BN epoch seconds" in out
    assert "DepCha/Funnel(Inception) ≥1.6×: True" in out
    assert out.splitlines()[-1] == "loaded []"
