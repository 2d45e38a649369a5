"""Multi-process dry runs of the port's multi-rank paths (the counterpart of
the JAX package's ``__graft_entry__.py dryrun_multichip`` and
``dryrun_multihost``), at TINY widths.

  python -m radialog_tpu_torch.parallel.dryrun [--n 2] [--device cuda|cpu]
  python -m radialog_tpu_torch.parallel.dryrun --multihost [--n 2] [--device cpu]

``dryrun_multichip(n, device)`` starts ``n`` rank processes of this module
that meet through ``core/mesh.init_distributed``'s RADIALOG_* environment:
gloo on the CPU, gloo on one card shared by every rank when the machine has
fewer than ``n`` cards (NCCL refuses two ranks on one device), NCCL with one
card a rank otherwise. On an (n/2 x 2) mesh (1 x 1 for one rank) they run
one data- and tensor-parallel LoRA step with remat, the sharded
``tp_generate``, a ``TPRingBatcher`` on each data row's model group, and on
an (n x 1) mesh one stage-1 step with its global-batch ITC/ITM/LM. Each
rank also runs the unsharded LoRA and stage-1 steps on the same global
batch, and the run checks every rank's losses against them (``TOL``).

``dryrun_multihost(num_processes, device)`` is the JAX package's multi-host
check: each rank stages only its ``host_local_batch_slice`` of the global
batch, runs one data-parallel LoRA step, and every rank's loss must be
equal, and equal to that of the same code in one process within ``TOL``.
JAX asserts bitwise equality there, its single- and multi-process runs
being one XLA program; here the ranks sum their gradients and losses in
another order than one process does.

The JAX package's ``entry()`` (one jitted forward for a graph checker) has
no counterpart: ``chip_smoke.py`` is the port's single-card check.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

# the losses of a multi-rank step against one process on the same global
# batch (f32 on the CPU, FP32 policy on a card): the same operations with
# the sums in another order, ~1e-7 relative on the CPU
TOL = {"rel": 1e-5}
MESH_TIMEOUT_S = 120.0
WAIT_S = 600.0
B, T = 8, 32


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _backend(n: int, device: str) -> str:
    if device == "cpu":
        return "gloo"
    import torch
    return "nccl" if torch.cuda.device_count() >= n else "gloo"


def _spawn(n: int, role: str, device: str, backend: str) -> List[Dict]:
    """``n`` rank processes of this module running ``role``; their results
    in rank order. Output goes to files (a rank that fills a pipe while its
    peers wait in a collective would stall the group); a rank that fails or
    outlives WAIT_S ends the run with the tails of every log."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for r in range(n):
            env = dict(os.environ, RADIALOG_COORDINATOR=f"localhost:{port}",
                       RADIALOG_NUM_PROCESSES=str(n), RADIALOG_PROCESS_ID=str(r),
                       PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                                                  if p))
            if device == "cpu":
                env.setdefault("OMP_NUM_THREADS", "1")
            log = open(os.path.join(tmp, f"{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "radialog_tpu_torch.parallel.dryrun", "--child", role,
                 "--device", device, "--backend", backend, "--out", os.path.join(tmp, f"{r}.json")],
                env=env, stdout=log, stderr=subprocess.STDOUT), log))
        deadline = time.time() + WAIT_S
        try:
            for p, _ in procs:
                p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        if any(p.returncode for p, _ in procs):
            tails = [open(os.path.join(tmp, f"{r}.log")).read()[-3000:] for r in range(n)]
            raise RuntimeError(f"dry run {role} on {n} ranks failed (rc "
                               f"{[p.returncode for p, _ in procs]}):\n" + "\n---\n".join(tails))
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"{r}.json")) as f:
                out.append(json.load(f))
    return out


def _close(got: float, want: float) -> bool:
    return abs(got - want) <= TOL["rel"] * max(abs(want), 1e-30)


def dryrun_multichip(n_devices: int = 2, device: str = "cuda") -> List[Dict]:
    """The multi-rank paths on ``n_devices`` ranks (module docstring);
    returns each rank's results and raises if a check fails."""
    res = _spawn(n_devices, "multichip", device, _backend(n_devices, device))
    r0 = res[0]
    checks = {
        "lora_ranks_equal": all(r["lora_loss"] == r0["lora_loss"]
                                and r["grad_norm"] == r0["grad_norm"] for r in res),
        "lora_vs_one_process": _close(r0["lora_loss"], r0["lora_loss_one_process"])
        and _close(r0["grad_norm"], r0["grad_norm_one_process"]),
        "generate_ranks_equal": all(r["generate"] == r0["generate"] for r in res),
        "generate_shape": [len(r0["generate"]), len(r0["generate"][0])] == [B, 4],
        "ring_rows_equal": all(r["ring"] == r0["ring"] for r in res if "ring" in r),
        "ring_sessions": len(r0["ring"]) == 3 and all(len(s) == 4 for s in r0["ring"]),
        "stage1_ranks_equal": all(r["stage1"] == r0["stage1"] for r in res),
        "stage1_vs_one_process": all(_close(r0["stage1"][k], r0["stage1_one_process"][k])
                                     for k in r0["stage1"]),
    }
    print(json.dumps({"dryrun": "multichip", "ranks": n_devices, "device": device,
                      "backend": r0["backend"], "mesh": r0["mesh"], "tol": TOL,
                      "lora_loss": r0["lora_loss"],
                      "lora_loss_one_process": r0["lora_loss_one_process"],
                      "grad_norm": r0["grad_norm"],
                      "grad_norm_one_process": r0["grad_norm_one_process"],
                      "stage1": r0["stage1"], "stage1_one_process": r0["stage1_one_process"],
                      "collectives_per_lora_step": r0["collectives"], "checks": checks}),
          flush=True)
    if not all(checks.values()):
        raise AssertionError(f"dryrun_multichip({n_devices}) failed: {checks}")
    return res


def dryrun_multihost(num_processes: int = 2, device: str = "cuda") -> Dict:
    """One data-parallel LoRA step, each rank staging only its slice of the
    global batch; every rank's loss equal, and equal to one process's within
    TOL. Returns the losses."""
    backend = _backend(num_processes, device)
    ranks = _spawn(num_processes, "multihost", device, backend)
    one = _spawn(1, "multihost", device, _backend(1, device))[0]
    losses = [r["loss"] for r in ranks]
    checks = {"ranks_equal": all(x == losses[0] for x in losses),
              "staged_own_slice_only": all(r["staged_rows"] == B * 2 // num_processes
                                           for r in ranks),
              "vs_one_process": _close(losses[0], one["loss"])}
    out = {"dryrun": "multihost", "processes": num_processes, "device": device,
           "backend": backend, "losses": losses, "one_process": one["loss"], "tol": TOL,
           "checks": checks}
    print(json.dumps(out), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"dryrun_multihost({num_processes}) failed: {checks}")
    return out


# --------------------------------------------------------------- rank side
def _lora_batch(cfg, b: int, t: int) -> Dict:
    """The global LoRA batch (numpy, the same on every rank): JAX's dry-run
    batch, with each row's first ``4 + row`` labels masked, so the data
    ranks hold different counts of valid labels."""
    import numpy as np
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, 200, (b, t)).astype(np.int32)
    tokens[:, 2:2 + cfg.num_img_tokens] = cfg.img_token_id
    labels = tokens.copy()
    for i in range(b):
        labels[i, :min(t - 2, 4 + 2 * i)] = -100
    return {"tokens": tokens, "labels": labels, "lengths": np.full((b,), t, np.int32),
            "img_embs": rng.normal(size=(b, cfg.num_img_tokens, cfg.qformer_dim))
            .astype(np.float32)}


def _weights(cfg, dev):
    """TINY's base and adapters from seed 0 on the host (the same on every
    rank), with LoRA ``b`` drawn too (zero, it would leave ``a`` without a
    gradient)."""
    import torch
    from ..models.llama import llama_init, lora_init
    from ..train.optim import tree_map
    gen = torch.Generator().manual_seed(0)
    base = llama_init(gen, cfg, device="cpu")
    lora = lora_init(gen, cfg, device="cpu")
    for ab in lora["layers"].values():
        ab["b"] = torch.randn(ab["b"].shape, generator=gen) * 0.1
    return tree_map(lambda x: x.to(dev), base), tree_map(lambda x: x.to(dev), lora)


def _adamw(specs=None, mesh=None):
    from ..train.optim import linear_warmup_cosine, make_adamw
    return make_adamw(linear_warmup_cosine(3e-4, 1e-5, 10, 100), weight_decay=0.05,
                      grad_clip=1.0, specs=specs, mesh=mesh)


def _lora_step(cfg, base, lora, batch, dev, mesh=None):
    """One AdamW LoRA step with remat: (loss, grad_norm) of the global
    batch, sharded over ``mesh`` or in this process alone."""
    from ..core.mesh import shard_batch
    from ..ops.layers import FP32
    from ..parallel.partition import llama_partition_specs, lora_partition_specs, shard_params
    from ..train.steps import TrainState, make_lora_train_step
    specs = lora_partition_specs(lora)
    tx = _adamw(specs, mesh)
    if mesh is not None:
        base = shard_params(mesh, base, llama_partition_specs(base))
        lora = shard_params(mesh, lora, specs)
        batch = shard_batch(mesh, batch, dev)
    else:
        batch = shard_batch(None, batch, dev)
    step = make_lora_train_step(tx, cfg, policy=FP32, remat=True, mesh=mesh)
    _, m = step(TrainState.create(lora, tx), base, batch)
    return float(m["loss"]), float(m["grad_norm"])


def _replica_mesh(n_data: int, n_model: int, device_type: str):
    """A (replica, data = 1, model) mesh: each data row of the training mesh
    is a replica whose model group serves alone (``TPRingBatcher`` shards
    the model axis only: serving data parallelism is request-level)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from ..core.mesh import DATA_AXIS, MODEL_AXIS, _backend_options
    backend = dist.get_backend()
    opts = (backend, _backend_options(backend, MESH_TIMEOUT_S))
    return init_device_mesh(device_type, (n_data, 1, n_model),
                            mesh_dim_names=("replica", DATA_AXIS, MODEL_AXIS),
                            backend_override={"replica": opts, DATA_AXIS: opts,
                                              MODEL_AXIS: opts})


def _stage1(dev, mesh=None) -> Dict:
    """One SGD stage-1 step (TINY Q-Former, 2 layers) on the global batch:
    the four global losses. The negatives come from a generator seeded
    alike on every rank."""
    import dataclasses
    import numpy as np
    import torch
    from ..core.mesh import DATA_AXIS, axis_group, shard_batch
    from ..models.blip2 import Blip2Config, blip2_init
    from ..models.qformer import TINY_QFORMER
    from ..train.optim import make_sgd, tree_map
    from ..train.steps import TrainState, make_stage1_train_step
    q = dataclasses.replace(TINY_QFORMER, bert=dataclasses.replace(TINY_QFORMER.bert,
                                                                   num_layers=2))
    cfg = Blip2Config(qformer=q, embed_dim=16, max_txt_len=12)
    params, _ = blip2_init(torch.Generator().manual_seed(1), cfg, "cpu", with_vision=False)
    params = tree_map(lambda x: x.to(dev), params)
    rng = np.random.default_rng(1)
    batch = {"image_embeds": rng.normal(size=(B, 6, q.encoder_width)).astype(np.float32),
             "text_ids": rng.integers(1, 100, (B, 10)).astype(np.int32),
             "text_mask": (np.arange(10)[None] < rng.integers(4, 10, (B, 1))).astype(np.int32)}
    tx = make_sgd(0.1, momentum=0.0)
    step = make_stage1_train_step(tx, cfg, data_group=axis_group(mesh, DATA_AXIS))
    gen = torch.Generator(device=dev).manual_seed(2)
    _, m = step(TrainState.create(params, tx), shard_batch(mesh, batch, dev), gen)
    return {k: float(v) for k, v in m.items()}


def _child_multichip(device: str, backend: str) -> Dict:
    import torch
    import torch.distributed as dist
    from ..core.mesh import (MODEL_AXIS, MeshSpec, axis_rank, init_distributed, make_mesh,
                             rank_device)
    from ..decode.engine import DecodeParams
    from ..models.llama import TINY_LLAMA
    from ..ops.layers import FP32
    from ..parallel import collectives
    from ..parallel.tp_ring import TPRingBatcher
    from ..parallel.tp_serving import make_tp_generate, shard_lora, shard_quantized_llama
    init_distributed(device=device, backend=backend, timeout=MESH_TIMEOUT_S)
    dev = rank_device(device)
    world = dist.get_world_size()
    n_model = 2 if world % 2 == 0 else 1
    n_data = world // n_model
    mesh = make_mesh(MeshSpec(n_data, n_model), device=dev.type, timeout=MESH_TIMEOUT_S)
    cfg = TINY_LLAMA
    base, lora = _weights(cfg, dev)
    batch = _lora_batch(cfg, B, T)
    out = {"backend": dist.get_backend(), "mesh": [n_data, n_model], "device": str(dev)}
    out["lora_loss_one_process"], out["grad_norm_one_process"] = _lora_step(
        cfg, base, lora, batch, dev)
    before = {f.__name__: f.calls for f in (collectives.copy_to_group,
                                            collectives.reduce_from_group,
                                            collectives.gather_last_dim, collectives.sum_over)}
    out["lora_loss"], out["grad_norm"] = _lora_step(cfg, base, lora, batch, dev, mesh)
    out["collectives"] = {f.__name__: f.calls - before[f.__name__]
                          for f in (collectives.copy_to_group, collectives.reduce_from_group,
                                    collectives.gather_last_dim, collectives.sum_over)}

    # the quantized serving path, sharded over the same mesh
    m_rank = axis_rank(mesh, MODEL_AXIS)
    params = shard_quantized_llama(base, cfg, n_model, m_rank, device=dev)
    lora_l = shard_lora(lora, cfg, n_model, m_rank)
    dp = DecodeParams(max_new_tokens=4, eos_token_id=-1)
    gen_fn = make_tp_generate(mesh, cfg, dp, has_img=True, has_lora=True, policy=FP32,
                              cache_len=64, kv_int8=True, device=dev)
    res = gen_fn(params, batch["tokens"], batch["lengths"], img_embs=batch["img_embs"],
                 lora=lora_l)
    out["generate"] = res.tokens.cpu().tolist()

    # continuous batching on each data row's model group
    replica = _replica_mesh(n_data, n_model, dev.type)
    ring = TPRingBatcher(replica, params, cfg, lanes=2, cache_len=64, prompt_len=32, dp=dp,
                         lora=lora_l, policy=FP32, steps_per_call=2, device=dev)
    if axis_rank(replica, MODEL_AXIS) == 0:
        img = torch.from_numpy(batch["img_embs"][:1]).to(dev)
        for row in batch["tokens"][:3]:
            ring.submit([int(x) for x in row[:12]], img, 4)
        try:
            finished = ring.run()
        finally:
            ring.close()
        out["ring"] = [finished[s].tokens for s in sorted(finished)]
    else:
        ring.serve_follower()

    # stage 1 over an (n x 1) mesh, and in this process alone
    dp_mesh = make_mesh(MeshSpec(world, 1), device=dev.type, timeout=MESH_TIMEOUT_S)
    out["stage1_one_process"] = _stage1(dev)
    out["stage1"] = _stage1(dev, dp_mesh)
    return out


def _child_multihost(device: str, backend: str) -> Dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from ..core.mesh import (MeshSpec, host_local_batch_slice, init_distributed, make_mesh,
                             rank_device)
    from ..models.llama import TINY_LLAMA
    from ..ops.layers import FP32
    from ..parallel.partition import lora_partition_specs
    from ..train.steps import TrainState, make_lora_train_step
    init_distributed(device=device, backend=backend, timeout=MESH_TIMEOUT_S)
    dev = rank_device(device)
    world = dist.get_world_size()
    mesh = make_mesh(MeshSpec(world, 1), device=dev.type, timeout=MESH_TIMEOUT_S)
    cfg = TINY_LLAMA
    base, lora = _weights(cfg, dev)
    glob = _lora_batch(cfg, 2 * B, T)
    sl = host_local_batch_slice(2 * B)        # this rank stages only its own rows
    local = {k: v[sl] for k, v in glob.items()}
    del glob
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in local.items()}
    tx = _adamw(lora_partition_specs(lora), mesh)
    step = make_lora_train_step(tx, cfg, policy=FP32, remat=True, mesh=mesh)
    _, m = step(TrainState.create(lora, tx), base, batch)
    return {"rank": dist.get_rank(), "world": world, "staged_rows": len(local["tokens"]),
            "loss": float(m["loss"])}


def _child(role: str, device: str, backend: str, out_path: str) -> int:
    import torch.distributed as dist
    fn = {"multichip": _child_multichip, "multihost": _child_multihost}[role]
    try:
        result = fn(device, backend)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(result, f)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2, help="rank processes")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--multihost", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--backend", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return _child(args.child, args.device, args.backend, args.out)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("dryrun: no CUDA device; pass --device cpu to run on the CPU",
                  file=sys.stderr)
            return 2
    if args.multihost:
        dryrun_multihost(args.n, args.device)
    else:
        dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
