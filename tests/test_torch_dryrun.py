"""The port's multi-process dry runs (radialog_tpu_torch/parallel/dryrun.py,
the counterpart of __graft_entry__.py's dryrun_multichip and
dryrun_multihost) on the CPU over gloo at TINY widths.

dryrun_multichip(2): a (1, 2) mesh; the TP LoRA step's loss and gradient
norm on both ranks within dryrun.TOL (1e-5 relative: f32 sums in another
order) of the same step in one process, the sharded generate and the TP ring
the same on both ranks, the stage-1 step's four global losses within TOL of
one process's. dryrun_multihost(2): each rank stages only its half of the
global batch; both ranks' losses bitwise equal (all-reduced) and within TOL
of one process's (JAX asserts bitwise equality there, its runs being one
XLA program).
"""
import os
import subprocess
import sys
from pathlib import Path

from radialog_tpu_torch.parallel import dryrun

REPO = Path(__file__).resolve().parents[1]


def _close(got, want):
    return abs(got - want) <= dryrun.TOL["rel"] * abs(want)


def test_multichip_two_ranks():
    ranks = dryrun.dryrun_multichip(2, "cpu")
    assert [r["mesh"] for r in ranks] == [[1, 2]] * 2
    for r in ranks:
        assert r["backend"] == "gloo"
        assert _close(r["lora_loss"], r["lora_loss_one_process"])
        assert _close(r["grad_norm"], r["grad_norm_one_process"])
        assert r["generate"] == ranks[0]["generate"] and len(r["generate"]) == dryrun.B
        for k, v in r["stage1_one_process"].items():
            assert _close(r["stage1"][k], v), k
    assert len(ranks[0]["ring"]) == 3 and "ring" not in ranks[1]     # rank 1 followed
    # f at q/k/v, gate/up of 2 layers and the lm_head; g at the embedding,
    # wo and down, and remat's replays of the attention's g
    assert ranks[0]["collectives"]["copy_to_group"] == 5
    assert ranks[0]["collectives"]["gather_last_dim"] == 1
    assert 5 < ranks[0]["collectives"]["reduce_from_group"] <= 9


def test_multihost_two_processes():
    out = dryrun.dryrun_multihost(2, "cpu")
    assert out["losses"][0] == out["losses"][1]
    assert _close(out["losses"][0], out["one_process"])
    assert all(out["checks"].values())


def test_cli_needs_a_card_unless_asked_for_the_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    done = subprocess.run([sys.executable, "-m", "radialog_tpu_torch.parallel.dryrun"],
                          capture_output=True, text=True, timeout=120, env=env)
    assert done.returncode == 2 and "--device cpu" in done.stderr
