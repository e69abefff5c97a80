"""The port's examples (``examples/*_torch.py``) run to their end on the
CPU, each in a subprocess with ``--device cpu``, and print what the JAX
package's examples print on the same seeds: the quickstart and the
community-detection run line for line (the port's lines name the device),
the serving example the same SCC count, generation, capacity and growth at
its first checkpoint.  The serving example is then killed-and-restarted
in effect: a second run over the same checkpoint directory resumes at the
committed chunk and generation.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(script, *args, jax=False):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def _without_device(text):
    return re.sub(r" on cpu$", "", text, flags=re.M)


def test_quickstart_torch_matches_jax():
    got = _run("quickstart_torch.py", "--device", "cpu")
    assert "n_sccs: 7 on cpu" in got
    assert _without_device(got) == _run("quickstart.py", jax=True)


def test_community_detection_torch_matches_jax():
    got = _run("community_detection_torch.py", "--device", "cpu")
    assert "on cpu" in got and "suggestion matrix" in got
    assert _without_device(got) == _run("community_detection.py", jax=True)


CKPT_LINE = re.compile(r"\[ckpt\] chunk (\d+) \| \d+ updates/s \| (\d+ SCCs "
                       r"\| gen=(\d+) \| capacity=(\d+) \(grows=\d+, "
                       r"replayed=\d+, compactions=\d+\))")


def test_dynamic_scc_serving_torch_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _run("dynamic_scc_serving_torch.py", "--smoke", "--device",
                 "cpu", "--ckpt-dir", ckpt, "--steps", "3", "--reset")
    chunk, state, gen, cap = CKPT_LINE.search(first).groups()
    assert chunk == "3" and "on cpu" in first
    # the JAX example's first checkpoint holds the same graph counters
    want = CKPT_LINE.search(_run("dynamic_scc_serving.py", "--smoke",
                                 "--steps", "3", "--readers", "0",
                                 jax=True))
    assert want.group(2) == state
    second = _run("dynamic_scc_serving_torch.py", "--smoke", "--device",
                  "cpu", "--ckpt-dir", ckpt, "--steps", "6")
    assert f"[recovery] resumed at chunk 3 (capacity {cap}, gen {gen})" \
        in second
    assert CKPT_LINE.search(second).group(1) == "6"
    assert "[preload]" not in second  # the graph came from the checkpoint
