"""Rank processes for the port's tensor-parallel CPU tests.

``run_ranks(job, n, tmp_dir)`` starts ``n`` processes of this file, which
meet through the RADIALOG_* environment (``core/mesh.init_distributed``,
gloo on the CPU), run the job named by ``job["kind"]`` (``JOBS``) and write
their results; it returns them in rank order. A job and its results are
dicts of numpy arrays and Python values, pickled by this module only. The
rank processes import torch and the port, never JAX.
"""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from typing import Dict, List

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(job: Dict, n: int, tmp_dir, timeout: float = 150.0) -> List[Dict]:
    path = os.path.join(str(tmp_dir), f"job-{job['kind']}.pkl")
    with open(path, "wb") as f:
        pickle.dump(job, f)
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RADIALOG_COORDINATOR=f"localhost:{port}",
                   RADIALOG_NUM_PROCESSES=str(n), RADIALOG_PROCESS_ID=str(r),
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        procs.append(subprocess.Popen([sys.executable, __file__, path, f"{path}.{r}"], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{logs[r][-4000:]}")
    out = []
    for r in range(n):
        with open(f"{path}.{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


# ------------------------------------------------------------------- jobs
def _np(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _mesh_job(job):
    import numpy as np
    import torch
    import torch.distributed as dist
    from radialog_tpu_torch.core import mesh as tm
    out = {"rank": dist.get_rank(), "world": tm.world_size(),
           "slice": tm.host_local_batch_slice(8)}
    x = torch.full((3,), float(dist.get_rank() + 1))
    dist.all_reduce(x)
    out["all_reduce"] = x.numpy()
    for shape in ((1, 2), (2, 1)):
        m = tm.make_mesh(tm.MeshSpec(*shape), device="cpu", timeout=60)
        batch = {"x": np.arange(8 * 3).reshape(8, 3), "y": [np.arange(8)]}
        got = tm.shard_batch(m, batch, device="cpu")
        out[shape] = {"data_rank": tm.axis_rank(m, tm.DATA_AXIS),
                      "model_rank": tm.axis_rank(m, tm.MODEL_AXIS),
                      "sizes": (tm.axis_size(m, tm.DATA_AXIS), tm.axis_size(m, tm.MODEL_AXIS)),
                      "x": got["x"].numpy(), "y": got["y"][0].numpy()}
    return out


def _serving_models(job, n_shards, rank, bits=8):
    from radialog_tpu_torch.models.llama import LlamaConfig
    from radialog_tpu_torch.parallel.tp_serving import shard_lora, shard_quantized_llama
    cfg = LlamaConfig(**job["cfg"])
    params = shard_quantized_llama(job["host"], cfg, n_shards, rank, bits=bits, device="cpu")
    lora = shard_lora(_tensors(job["lora"]), cfg, n_shards, rank)
    return cfg, params, lora


def _tensors(tree):
    import numpy as np
    import torch
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _serving_job(job):
    """Every case of tests/test_torch_tp_serving.py's spawned group."""
    from radialog_tpu_torch.core import mesh as tm
    from radialog_tpu_torch.decode.engine import DecodeParams
    from radialog_tpu_torch.ops.layers import FP32
    from radialog_tpu_torch.parallel.tp_serving import make_tp_generate
    meshes = {1: tm.make_mesh(tm.MeshSpec(2, 1), device="cpu", timeout=60),
              2: tm.make_mesh(tm.MeshSpec(1, 2), device="cpu", timeout=60)}
    dp = DecodeParams(**job["dp"])
    out = {}
    for name, case in job["cases"].items():
        n = case["tp"]
        mesh = meshes[n]
        cfg, params, lora = _serving_models(job, n, tm.axis_rank(mesh, tm.MODEL_AXIS),
                                            case.get("bits", 8))
        fn = make_tp_generate(mesh, cfg, dp, has_img=case["img"], has_lora=case["lora"],
                              policy=FP32, cache_len=case["cache_len"],
                              kv_int8=case["kv_int8"], shared_prefix=case["prefix"],
                              num_beams=case["beams"], device="cpu")
        tokens = job["tokens"] if case["img"] else job["tokens_noimg"]
        res = fn(params, tokens, job["lengths"], img_embs=job["img"] if case["img"] else None,
                 lora=lora if case["lora"] else None,
                 prefix_tokens=job["prefix"] if case["prefix"] else None)
        out[name] = {k: _np(v) for k, v in res._asdict().items()}
    return out


def _drive(batcher, prompts, imgs, max_new):
    """Staggered submissions (tests/test_tp_ring.py's): 2 up front, the rest
    one per step."""
    sids = [batcher.submit(prompts[i], imgs[i], max_new) for i in range(2)]
    pending = list(range(2, len(prompts)))
    for _ in range(200):
        if pending:
            i = pending.pop(0)
            sids.append(batcher.submit(prompts[i], imgs[i], max_new))
        batcher.step()
        if not pending and batcher.active_lanes == 0 and not batcher.queue:
            break
    return [batcher.finished.pop(s).tokens for s in sids]


def _ring_job(job):
    """tests/test_torch_tp_ring.py's group: on a (1, 2) mesh, rank 0 drives
    a TPRingBatcher through the staggered schedule, then serves the same
    prompts through RaDialogServer from 2 client threads; rank 1 follows.
    Both then try a (2, 1) mesh, which the batcher refuses."""
    import threading
    import torch
    from radialog_tpu_torch.apps.serve import RaDialogServer
    from radialog_tpu_torch.core import mesh as tm
    from radialog_tpu_torch.decode.engine import DecodeParams
    from radialog_tpu_torch.models.llama import LlamaConfig
    from radialog_tpu_torch.ops.layers import FP32
    from radialog_tpu_torch.parallel.tp_ring import TPRingBatcher
    from radialog_tpu_torch.parallel.tp_serving import shard_lora, shard_quantized_llama
    mesh12 = tm.make_mesh(tm.MeshSpec(1, 2), device="cpu", timeout=60)
    mesh21 = tm.make_mesh(tm.MeshSpec(2, 1), device="cpu", timeout=60)
    cfg = LlamaConfig(**job["cfg"])
    rank = tm.axis_rank(mesh12, tm.MODEL_AXIS)
    params = shard_quantized_llama(job["host"], cfg, 2, rank, device="cpu")
    lora = shard_lora(_tensors(job["lora"]), cfg, 2, rank)
    dp = DecodeParams(**job["dp"])
    tp = TPRingBatcher(mesh12, params, cfg, lanes=2, cache_len=64, prompt_len=32, dp=dp,
                       lora=lora, policy=FP32, steps_per_call=2, device="cpu")
    imgs = [torch.from_numpy(x) for x in job["imgs"]]
    out = {}
    if rank == 0:
        out["drive"] = _drive(tp, job["prompts"], imgs, dp.max_new_tokens)
        srv = RaDialogServer(batcher=tp)
        futs = {}

        def client(ids):
            for i in ids:
                futs[i] = srv.submit(job["prompts"][i], imgs[i], dp.max_new_tokens)
        threads = [threading.Thread(target=client, args=(ids,)) for ids in ((0, 2), (1, 3))]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            out["served"] = [futs[i].result(timeout=120) for i in range(len(job["prompts"]))]
        finally:
            srv.shutdown()
            tp.close()
    else:
        out["chunks"] = tp.serve_follower()
    out["digests"] = list(tp.chunk_digests)
    try:
        TPRingBatcher(mesh21, params, cfg, lanes=2, cache_len=64, prompt_len=32, device="cpu")
    except ValueError as e:
        out["data_refused"] = str(e)
    return out


JOBS = {"mesh": _mesh_job, "serving": _serving_job, "ring": _ring_job}


def main(job_path: str, out_path: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from radialog_tpu_torch.core.mesh import init_distributed
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    first = init_distributed(device="cpu", timeout=60)
    again = init_distributed(device="cpu", timeout=60)
    try:
        result = JOBS[job["kind"]](job)
        result["init"] = (first, again, dist.get_backend())
        result["jax_imported"] = "jax" in sys.modules
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
