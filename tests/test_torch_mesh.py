"""The port's process groups and mesh (radialog_tpu_torch/core/mesh.py)
against radialog_tpu/core/mesh.py: ``MeshSpec.resolve`` and
``host_local_batch_slice`` on the same inputs (equal results, the same
refusals), ``init_distributed``'s single-process no-op, and two gloo rank
processes (tests/torch_tp_ranks.py) meeting through the RADIALOG_*
environment: init twice (idempotent), an all-reduce, (1, 2) and (2, 1)
meshes with each rank's coordinates and its ``shard_batch`` slice."""

import numpy as np
import pytest

from radialog_tpu.core import mesh as jm
from radialog_tpu_torch.core import mesh as tm

import torch_tp_ranks

SPECS = [(-1, 1, 8), (-1, 2, 8), (4, 2, 8), (2, 4, 8), (1, 2, 2), (2, 1, 2), (-1, 8, 8),
         (1, 1, 1)]
BAD = [(-1, 3, 8), (3, 2, 8), (2, 2, 2)]


@pytest.mark.parametrize("data,model,n", SPECS)
def test_resolve_matches_jax(data, model, n):
    assert tm.MeshSpec(data, model).resolve(n) == jm.MeshSpec(data, model).resolve(n)


@pytest.mark.parametrize("data,model,n", BAD)
def test_resolve_refusals_match_jax(data, model, n):
    for spec in (tm.MeshSpec(data, model), jm.MeshSpec(data, model)):
        with pytest.raises(ValueError):
            spec.resolve(n)


def test_host_local_batch_slice_matches_jax():
    for batch, count in ((8, 1), (8, 2), (8, 4), (12, 3), (16, 8)):
        for index in range(count):
            assert tm.host_local_batch_slice(batch, index, count) == \
                jm.host_local_batch_slice(batch, index, count)
    for fn in (tm.host_local_batch_slice, jm.host_local_batch_slice):
        with pytest.raises(ValueError, match="not divisible"):
            fn(10, 0, 4)
    # no process group: one process holds the whole batch, as in JAX
    assert tm.host_local_batch_slice(8) == slice(0, 8)


def test_single_process_is_a_noop(monkeypatch):
    for var in ("RADIALOG_COORDINATOR", "RADIALOG_NUM_PROCESSES", "RADIALOG_PROCESS_ID",
                "RADIALOG_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    assert tm.init_distributed(device="cpu") is False
    assert jm.init_distributed() is False
    assert tm.world_size() == 1 and tm.MeshSpec().resolve() == (1, 1)
    with pytest.raises(RuntimeError, match="init_distributed"):
        tm.make_mesh(tm.MeshSpec(), device="cpu")
    with pytest.raises(ValueError, match="RADIALOG_NUM_PROCESSES"):
        tm.init_distributed("localhost:1", device="cpu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_tp_ranks.run_ranks({"kind": "mesh"}, 2, tmp_path_factory.mktemp("mesh"))


def test_two_processes_meet(ranks):
    for r, out in enumerate(ranks):
        assert out["init"] == (True, True, "gloo")       # joined, then idempotent
        assert out["rank"] == r and out["world"] == 2
        assert out["slice"] == jm.host_local_batch_slice(8, r, 2)
        np.testing.assert_array_equal(out["all_reduce"], np.full(3, 3.0))
        assert not out["jax_imported"]


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_mesh_coordinates_and_batch_slices(shape, ranks):
    """Rank r sits at (r // model, r % model), as the JAX mesh's row-major
    device grid; each takes its data rank's contiguous slice."""
    data, model = shape
    x = np.arange(24).reshape(8, 3)
    for r, out in enumerate(ranks):
        got = out[shape]
        assert got["sizes"] == shape
        assert (got["data_rank"], got["model_rank"]) == (r // model, r % model)
        sl = jm.host_local_batch_slice(8, r // model, data)
        np.testing.assert_array_equal(got["x"], x[sl])
        np.testing.assert_array_equal(got["y"], np.arange(8)[sl])
