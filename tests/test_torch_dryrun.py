"""The port's dry-run (``repro_torch.launch.dryrun``) on fake process groups
of 256 and 512 ranks, in a subprocess (the fake group is this process's
default group while it lives).

The cells are the reference lowering test's (gatedgcn:molecule,
mind:serve_p99, smscc:community_query), plus the LM train step at
qwen3-14b's full width with one layer (``lm_layers``, the reference's own
layer knob) and the SMSCC update's metered round; each must reach
``ok``, and qwen3-14b:long_500k is ``skipped``.  The meter must count a
known all-gather's bytes, as the reference's collective parser does for
its HLO.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DRYRUN = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import dryrun, mesh as ml

    multi_pod = sys.argv[1] == "1"
    dryrun.fake_process_group(512 if multi_pod else 256)
    mesh = ml.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
    # a known all-gather: bf16 [128, 128] sharded 16 ways over 'data'
    pl = ml.placements(ml.P("data", None), mesh)
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(8, 128, dtype=torch.bfloat16),
                               mesh, pl, run_check=False,
                               shape=torch.Size([128, 128]), stride=(128, 1))
        with dryrun.Meter() as m:
            x.full_tensor()
    print(json.dumps({"gather": dict(m.collectives)}))
    for arch, shape in [("gatedgcn", "molecule"), ("mind", "serve_p99"),
                        ("smscc", "community_query"),
                        ("smscc", "update_1m"), ("qwen3-14b", "train_4k"),
                        ("qwen3-14b", "long_500k")]:
        rec = dryrun.run_cell(arch, shape, multi_pod, lm_layers=1)
        print(json.dumps({k: rec.get(k) for k in (
            "arch", "shape", "mesh", "status", "error", "collectives",
            "memory", "cost", "roofline", "replicated_ops")}), flush=True)
""")


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_dryrun_cells(multi_pod):
    r = subprocess.run(
        [sys.executable, "-c", DRYRUN, "1" if multi_pod else "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT,
        env={"PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1",
             "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "HOME": os.environ.get("HOME", ROOT)})
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(x) for x in r.stdout.splitlines()
             if x.startswith("{")]
    gather = lines[0]["gather"]
    assert gather["all-gather"] == 128 * 128 * 2     # result side
    assert gather["count_all-gather"] == 1
    recs = {(x["arch"], x["shape"]): x for x in lines[1:]}
    mesh = "2x16x16" if multi_pod else "16x16"
    assert recs[("qwen3-14b", "long_500k")]["status"] == "skipped"
    for key, rec in recs.items():
        if key == ("qwen3-14b", "long_500k"):
            continue
        assert rec["status"] == "ok", (key, rec.get("error"))
        assert rec["mesh"] == mesh
        assert rec["memory"]["peak_live_bytes"] >= \
            rec["memory"]["argument_size_in_bytes"] > 0
        assert rec["roofline"]["bottleneck"] in (
            "compute_s", "memory_s", "collective_s")
    # the update's round merges labels with an all-reduce-min
    assert recs[("smscc", "update_1m")]["collectives"]["count_all-reduce"] \
        >= 1
    assert recs[("qwen3-14b", "train_4k")]["cost"]["flops"] > 0
