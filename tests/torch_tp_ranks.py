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


def _leaves(tree):
    from radialog_tpu_torch.train.optim import tree_leaves
    return tree_leaves(tree)


def _flat_np(tree, prefix=""):
    """{"a/0/c": numpy leaf} of a tree of dicts and lists."""
    items = tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, (list, tuple)) else None
    if items is None:
        return {prefix.rstrip("/"): _np(tree)}
    return {p: v for k, sub in items for p, v in _flat_np(sub, f"{prefix}{k}/").items()}


def _partition_job(job):
    """tests/test_torch_partition.py's group: on a (1, 2) mesh each case's
    base (and LoRA) sharded and gathered back, the local shapes checked,
    and, where the case has tokens, the TP = 2 forward of the stacked
    layout."""
    import torch
    from radialog_tpu_torch.core import mesh as tm
    from radialog_tpu_torch.models import llama as tl
    from radialog_tpu_torch.ops.layers import FP32
    from radialog_tpu_torch.parallel import partition as pt
    from radialog_tpu_torch.parallel.tp_serving import shard_config
    mesh = tm.make_mesh(tm.MeshSpec(1, 2), device="cpu", timeout=60)
    group = tm.axis_group(mesh, tm.MODEL_AXIS)
    out = {}
    for name, case in job["cases"].items():
        base, lora = case["base"], case["lora"]
        got = {}
        for what, tree, specs in (("base", base, pt.llama_partition_specs(base)),
                                  ("lora", lora, pt.lora_partition_specs(lora))):
            local = pt.shard_params(mesh, tree, specs)
            pt.with_sharding_constraints(local, specs, mesh, pt.shapes_of(tree))
            back = pt.gather_params(mesh, local, specs, pt.shapes_of(tree))
            got[f"{what}_identity"] = all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(_leaves(back), _leaves(tree)))
            got[f"{what}_local_shapes"] = [tuple(x.shape) for x in _leaves(local)]
            if what == "base":
                lb = local
                head = local["lm_head"].get("w", local["lm_head"].get("w_q"))
                got["vocab_rows"] = (local["embed"].shape[0], head.shape[1])
                got["wq_cols"] = local["layers"]["wq"].get("w", local["layers"]["wq"].get(
                    "w_q")).shape[-1]
                try:
                    bad = dict(local, embed=local["embed"][:-1])
                    pt.with_sharding_constraints(bad, specs, mesh, pt.shapes_of(tree))
                except ValueError as e:
                    got["refused"] = str(e)
            else:
                ll = local
        if "tokens" in case:
            cfg = tl.LlamaConfig(**case["cfg"])
            toks = torch.from_numpy(case["tokens"])
            lens = torch.from_numpy(case["lengths"])
            b, t = toks.shape
            pos = torch.arange(t)[None].repeat(b, 1)
            img = torch.from_numpy(case["img_embs"])
            logits, _ = tl.llama_apply(lb, shard_config(cfg, 2), toks, pos,
                                       tl.prefill_bias(lens, t), img_embs=img,
                                       img_start=tl.find_img_start(toks, cfg.img_token_id),
                                       lora=ll, policy=FP32, lengths=lens, tp_group=group)
            got["logits"] = _np(logits)
            got["embed"] = _np(tl.vocab_parallel_embed(lb["embed"], toks, group))
        out[name] = got
    return out


def _train_job(job):
    """tests/test_torch_train_parallel.py's groups: each case one SGD LoRA
    step (remat) on its mesh, from the whole trees and the global batch the
    test sends; returns the global metrics, this rank's updated local tree
    and, gathered, the whole one. A case with ``no_f`` runs with the
    identity in place of copy_to_group (the trap the f-op closes). Stage-1
    cases run make_stage1_train_step over the data axis, with the global
    negatives the test sends in place of sample_negatives."""
    import torch
    from radialog_tpu_torch.core import mesh as tm
    from radialog_tpu_torch.models import blip2 as tb
    from radialog_tpu_torch.models import llama as tl
    from radialog_tpu_torch.ops.layers import FP32
    from radialog_tpu_torch.parallel import collectives
    from radialog_tpu_torch.parallel import partition as pt
    from radialog_tpu_torch.train import optim as toptim
    from radialog_tpu_torch.train import steps as tsteps
    meshes = {}
    out = {}
    for name, case in job["cases"].items():
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = tm.make_mesh(tm.MeshSpec(*shape), device="cpu", timeout=60)
        mesh = meshes[shape]
        tx = toptim.make_sgd(job["lr"], momentum=0.0)
        batch = tm.shard_batch(mesh, case["batch"], device="cpu")
        if case.get("stage1"):
            want = tuple(torch.from_numpy(x) for x in case["negatives"])
            real = tb.sample_negatives
            tb.sample_negatives = lambda w_t2i, w_i2t, gen: want
            try:
                step = tsteps.make_stage1_train_step(
                    tx, tb.Blip2Config(**case["cfg"]),
                    data_group=tm.axis_group(mesh, tm.DATA_AXIS))
                state, m = step(tsteps.TrainState.create(case["params"], tx), batch, None)
            finally:
                tb.sample_negatives = real
            out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                         "params": _flat_np(state.params)}
            continue
        base, lora = case["base"], case["lora"]
        specs = pt.lora_partition_specs(lora)
        lb = pt.shard_params(mesh, base, pt.llama_partition_specs(base))
        ll = pt.shard_params(mesh, lora, specs)
        real_f = tl.copy_to_group
        if case.get("no_f"):
            tl.copy_to_group = lambda x, group: x
        calls = {f.__name__: f.calls for f in (collectives.copy_to_group,
                                                collectives.reduce_from_group,
                                                collectives.sum_over)}
        try:
            step = tsteps.make_lora_train_step(tx, tl.LlamaConfig(**case["cfg"]), policy=FP32,
                                               remat=True, flash=case.get("flash", False),
                                               mesh=mesh)
            state, m = step(tsteps.TrainState.create(ll, tx), lb, batch)
        finally:
            tl.copy_to_group = real_f
        out[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "local": _flat_np(state.params),
                     "params": _flat_np(pt.gather_params(mesh, state.params, specs)),
                     "calls": {k: f.calls - calls[k] for k, f in
                               (("copy_to_group", collectives.copy_to_group),
                                ("reduce_from_group", collectives.reduce_from_group),
                                ("sum_over", collectives.sum_over))}}
    return out


def _timeout_job(job):
    """A rank that raises inside the backward: rank 1's loss hook raises
    before the backward's first collective, and it stays alive without
    joining; rank 0 waits in that collective until the mesh's timeout
    (job["timeout"] seconds) and must raise, not hang."""
    import time
    import torch
    from radialog_tpu_torch.core import mesh as tm
    from radialog_tpu_torch.ops.layers import FP32
    from radialog_tpu_torch.parallel import partition as pt
    from radialog_tpu_torch.train import optim as toptim
    from radialog_tpu_torch.train import steps as tsteps
    from radialog_tpu_torch.models import llama as tl
    mesh = tm.make_mesh(tm.MeshSpec(1, 2), device="cpu", timeout=job["timeout"])
    rank = tm.axis_rank(mesh, tm.MODEL_AXIS)
    base, lora = job["base"], job["lora"]
    specs = pt.lora_partition_specs(lora)
    lb = pt.shard_params(mesh, base, pt.llama_partition_specs(base))
    ll = pt.shard_params(mesh, lora, specs)
    tx = toptim.make_sgd(0.1, momentum=0.0)
    step = tsteps.make_lora_train_step(tx, tl.LlamaConfig(**job["cfg"]), policy=FP32,
                                       remat=True, mesh=mesh)
    real = tsteps.masked_ce
    if rank == 1:
        def failing(logits, labels, data_group=None):
            def fail(_):
                raise RuntimeError("injected failure inside the backward")
            logits.register_hook(fail)
            return real(logits, labels, data_group)
        tsteps.masked_ce = failing
    t0 = time.time()
    try:
        step(tsteps.TrainState.create(ll, tx), lb, tm.shard_batch(mesh, job["batch"], "cpu"))
        result = {"raised": None}
    except RuntimeError as e:
        result = {"raised": str(e)[:300]}
    finally:
        tsteps.masked_ce = real
    result["seconds"] = time.time() - t0
    if rank == 1:       # alive, but never joins the collective rank 0 waits in
        time.sleep(job["timeout"] + 4)
    return result


def _finetune_job(job):
    """tests/test_torch_finetune_parallel.py's group: apps/finetune_lora.train
    on the two ranks at mesh_model 2 and 1 (output dirs under job["out"]),
    the gathered adapter export, a resume from a one-process TrainState, and
    the refusal of mesh_model 3."""
    import dataclasses
    import torch.distributed as dist
    from radialog_tpu_torch.apps import finetune_lora as tft
    from radialog_tpu_torch.core import mesh as tm
    from radialog_tpu_torch.parallel import partition as pt
    out = {}
    for m in (2, 1):
        logs = []
        cfg = tft.FinetuneConfig(**job["cfg"], mesh_model=m, output_dir=f"{job['out']}/m{m}")
        state = tft.train(cfg, log_fn=logs.append, base=job["base"], lora=job["lora"])
        mesh = tm.make_mesh(tm.MeshSpec(model=m), device="cpu", timeout=60)
        tft.export_adapter(state.params, f"{job['out']}/m{m}.bin", mesh=mesh)
        out[m] = {"logs": logs, "step": state.step,
                  "params": _flat_np(pt.gather_params(
                      mesh, state.params, pt.lora_partition_specs(state.params)))}
    logs = []
    cfg = tft.FinetuneConfig(**dict(job["cfg"], max_steps=2), mesh_model=2,
                             resume_from_checkpoint=job["resume"],
                             output_dir=f"{job['out']}/resumed")
    state = tft.train(cfg, log_fn=logs.append, base=job["base"])
    mesh = tm.make_mesh(tm.MeshSpec(model=2), device="cpu", timeout=60)
    out["resumed"] = {"logs": logs, "step": state.step, "params": _flat_np(
        pt.gather_params(mesh, state.params, pt.lora_partition_specs(state.params)))}
    try:
        tft.train(dataclasses.replace(cfg, mesh_model=3, resume_from_checkpoint=None),
                  base=job["base"])
    except ValueError as e:
        out["refused"] = str(e)
    out["rank"] = dist.get_rank()
    return out


JOBS = {"mesh": _mesh_job, "serving": _serving_job, "ring": _ring_job,
        "partition": _partition_job, "train": _train_job, "timeout": _timeout_job,
        "finetune": _finetune_job}


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
