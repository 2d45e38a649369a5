"""Tensor-parallel continuous batching: ``RingBatcher`` over the model axis
of a mesh (port of radialog_tpu/parallel/tp_ring.py).

Each rank of the model group holds its ``shard_quantized_llama`` shard (or
a shard of any unrolled serving tree) and a bf16 ring cache of its own
heads, (L, lanes, S, H/n, D): the decode step and the admission prefill are
``RingBatcher``'s own programs over ``shard_config``'s local counts, with
the row-parallel partials summed over the group inside ``llama_apply``.
The logits are replicated after the last sum, so every rank computes the
same tokens. As in JAX the ring is bf16 only (a quantized TP ring would
shard the token-flat int8 rows and is not implemented), and the batcher
covers the model axis only: serving data parallelism is request-level, one
batcher per replica group behind a router.

Multi-controller protocol. The JAX package runs one host loop for every
chip; here every rank runs its own, and they must stay in lock step. Model
rank 0 owns the request queue and is the ``RingBatcher`` a
``RaDialogServer(batcher=...)`` drives unchanged. Before each device
program it broadcasts what the other ranks need to run it:

  * an admission: lane, bucketed prompt tokens, length, image embeddings;
  * a decode chunk: the ring base, the set of active lanes, and a checksum
    of its last tokens and positions, against which each follower checks
    its own copy (tokens come from the replicated logits, so no token is
    sent: a follower that computed other ones raises instead of running
    on).

Every other rank runs ``serve_follower()``, which executes those commands
until rank 0's ``close()``. Every collective times out with the group
(``core/mesh.py``), so ranks that lose step raise rather than hang.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.mesh import DATA_AXIS, MODEL_AXIS, axis_group, axis_rank, axis_size
from ..decode.continuous import RingBatcher
from ..decode.engine import DecodeParams
from ..ops.layers import BF16, DTypePolicy
from .tp_serving import shard_config

_STOP, _ADMIT, _STEP = 0, 1, 2
_HEAD = 8   # command words before the lane mask


def _checksum(last_tok: np.ndarray, cur_lens: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(last_tok, np.int32).tobytes()
                      + np.ascontiguousarray(cur_lens, np.int32).tobytes())


class TPRingBatcher(RingBatcher):
    """Continuous batching with every device program sharded over the model
    axis of ``mesh`` (a ``make_mesh`` DeviceMesh whose data axis is 1).
    ``params`` / ``lora`` are this rank's shard (``shard_quantized_llama``,
    ``shard_lora``); ``cfg`` is the unsharded config. On model rank 0 it is a
    drop-in ``RingBatcher`` (submit / step / run / validate_request); on the
    other ranks call ``serve_follower()``. ``chunk_digests`` records a CRC of
    every decode chunk's tokens, for comparing ranks."""

    def __init__(self, mesh, params: Dict, cfg, lanes: int = 4, cache_len: int = 512,
                 prompt_len: int = 256, dp: DecodeParams = DecodeParams(),
                 lora: Optional[Dict] = None, policy: DTypePolicy = BF16,
                 steps_per_call: int = 1, device="cuda"):
        if axis_size(mesh, DATA_AXIS) != 1:
            raise ValueError(
                "TPRingBatcher shards the model axis only (lanes are global "
                "on every rank); run one batcher per data replica: serving "
                "data-parallelism is request-level (see module docstring)")
        self.mesh = mesh
        self.global_cfg = cfg
        self.n_model = axis_size(mesh, MODEL_AXIS)
        self.model_rank = axis_rank(mesh, MODEL_AXIS)
        self.tp_group = axis_group(mesh, MODEL_AXIS)
        self.chunk_digests: List[int] = []
        if self.n_model > 1:
            on_nccl = dist.get_backend(self.tp_group) == "nccl"
            self._comm_device = torch.device(device) if on_nccl else torch.device("cpu")
            self._src = dist.get_global_rank(self.tp_group, 0)
        # RingBatcher's programs and cache run at the shard's counts
        super().__init__(params, shard_config(cfg, self.n_model), lanes=lanes,
                         cache_len=cache_len, prompt_len=prompt_len, dp=dp, lora=lora,
                         policy=policy, steps_per_call=steps_per_call, kv_int8=False,
                         device=device)

    # ------------------------------------------------------------ collectives
    def _bcast(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self._comm_device).contiguous()
        dist.broadcast(x, src=self._src, group=self.tp_group)
        return x

    def _send(self, cmd: int, words=(), active=None) -> None:
        head = torch.zeros(_HEAD + self.lanes, dtype=torch.int64)
        head[0] = cmd
        head[1:1 + len(words)] = torch.tensor(words, dtype=torch.int64)
        if active is not None:
            head[_HEAD:] = torch.as_tensor(np.asarray(active, np.int64))
        self._bcast(head)

    def _recv(self) -> torch.Tensor:
        return self._bcast(torch.zeros(_HEAD + self.lanes, dtype=torch.int64)).cpu()

    # ------------------------------------------------------------------ hooks
    def _build_fns(self) -> None:
        super()._build_fns()
        self._prefill_local, self._step_local = self._prefill_fn, self._step_fn
        if self.n_model == 1:
            return

        def prefill_fn(tokens, length: int, lane: int, img_embs):
            # rank 0 runs on the very tensors it sent
            has_img = img_embs is not None
            shape = tuple(img_embs.shape[-2:]) if has_img else (0, 0)
            self._send(_ADMIT, (lane, tokens.shape[1], length, int(has_img), *shape))
            tokens = self._bcast(tokens.long()).to(self.device, torch.int32)
            img = None
            if has_img:
                img = self._bcast(img_embs.float().reshape(1, *shape)).to(self.device)
            return self._prefill_local(tokens, length, lane, img)

        def step_fn(last_tok, cur_lens, active, ring_base: int, prompt_lens, writes):
            self._send(_STEP, (ring_base, _checksum(last_tok.cpu().numpy(),
                                                    cur_lens.cpu().numpy())),
                       active=active.cpu().numpy())
            out = self._step_local(last_tok, cur_lens, active, ring_base, prompt_lens, writes)
            self.chunk_digests.append(zlib.crc32(out[2].cpu().numpy().tobytes()))
            return out

        if self.model_rank == 0:
            self._prefill_fn, self._step_fn = prefill_fn, step_fn

    # --------------------------------------------------------------- interface
    def close(self) -> None:
        """Rank 0: end every follower's ``serve_follower`` loop."""
        if self.n_model > 1 and self.model_rank == 0:
            self._send(_STOP)

    def serve_follower(self) -> int:
        """A rank other than 0: run rank 0's admissions and decode chunks on
        this rank's shard until ``close()``; returns the chunks run. Raises
        if this rank's last tokens or positions part from rank 0's."""
        if self.model_rank == 0 or self.n_model == 1:
            raise ValueError("serve_follower runs on model ranks other than 0")
        lanes, k = self.lanes, self.steps_per_call
        last_tok, cur_lens = np.zeros(lanes, np.int32), np.zeros(lanes, np.int32)
        prompt_lens, writes = np.zeros(lanes, np.int32), np.zeros(lanes, np.int32)

        def dev(x):
            return torch.from_numpy(x).to(self.device)
        chunks = 0
        while True:
            head = self._recv()
            cmd = int(head[0])
            if cmd == _STOP:
                return chunks
            if cmd == _ADMIT:
                lane, tpad, length, has_img, n, q = (int(v) for v in head[1:7])
                tokens = self._bcast(torch.zeros((1, tpad), dtype=torch.int64))
                img = (self._bcast(torch.zeros((1, n, q), dtype=torch.float32)).to(self.device)
                       if has_img else None)
                first = self._prefill_local(tokens.to(self.device, torch.int32), length,
                                            lane, img)
                last_tok[lane], cur_lens[lane] = int(first), length
                prompt_lens[lane], writes[lane] = length, 0
                continue
            if cmd != _STEP:
                raise RuntimeError(f"unknown command {cmd} from rank 0")
            ring_base, check = int(head[1]), int(head[2])
            active = head[_HEAD:].numpy().astype(np.bool_)
            if check != _checksum(last_tok, cur_lens):
                raise RuntimeError("tensor-parallel ranks lost step: this rank's last tokens "
                                   "or positions differ from rank 0's")
            lt, cl, toks = self._step_local(dev(last_tok), dev(cur_lens), dev(active),
                                            ring_base, dev(prompt_lens), dev(writes))
            writes[active] += k
            last_tok, cur_lens = lt.cpu().numpy().copy(), cl.cpu().numpy().copy()
            self.chunk_digests.append(zlib.crc32(toks.cpu().numpy().tobytes()))
            chunks += 1
