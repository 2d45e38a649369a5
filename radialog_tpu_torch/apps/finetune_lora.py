"""LoRA finetuning loop (port of radialog_tpu/apps/finetune_lora.py, the
logic behind the JAX package's root finetune.py).

One train step over one device: AdamW with a warm-up and cosine schedule,
gradient accumulation over micro-batches (batch_size / micro_batch_size),
prompt-masked labels, balanced report/instruct sampling, best/last
checkpoints, and the adapter export in the reference's adapter_model.bin
format. The frozen base is float or, with ``quantize_base``, int8
(ops/quant.py); with ``flash`` attention runs through the flash-attention
kernels forward and backward (ops/flash_attention.py).

Weights are ``mock`` (TINY_LLAMA, seeded on the host, so a CPU run and a
card run start from the same numbers), ``synthetic`` (Vicuna-7B widths,
random weights from a seeded generator on the device, bf16 compute) or, as
in the JAX package, the Vicuna checkpoint directory ``base_model`` (its
tokenizer and safetensors or ``pytorch_model*.bin`` shards; bf16, or int8
with ``quantize_base``), with a PEFT adapter ``lora_weights`` to start from.

  python -m radialog_tpu_torch.apps.finetune_lora --mock true \\
      --data_path tests/fixtures/instruct.json --batch_size 4 \\
      --micro_batch_size 2 --num_epochs 1 --max_steps 4 --cutoff_len 64 \\
      --use_embs true --output_dir /tmp/lora-out [--device cpu]
  python -m radialog_tpu_torch.apps.finetune_lora --base_model VICUNA_DIR \\
      --lora_weights ADAPTER_DIR/adapter_model.bin --quantize_base true \\
      --data_path DATA.json --output_dir OUT_DIR
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
import typing
import zlib
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.checkpoint import BestKeeper, load_checkpoint
from ..data.datasets import (balanced_epoch_indices, load_instruct_dataset,
                             split_report_instruct)
from ..models.llama import LlamaConfig, TINY_LLAMA, VICUNA_7B, llama_init, lora_init
from ..ops.layers import BF16, FP32, set_precision
from ..ops.quant import quantize_llama, quantize_llama_np, random_q8_train_base
from ..train.optim import linear_warmup_cosine, make_adamw, tree_map
from ..train.steps import TrainState, lora_loss_fn, make_lora_train_step
from ..utils import hf_weights
from . import tokenization
from .tokenization import (Prompter, WhitespaceTokenizer, pad_batch_right, pad_labels_right,
                           tokenize_with_masked_prompt)


@dataclasses.dataclass
class FinetuneConfig:
    """The reference's keyword surface, as the JAX package keeps it."""

    base_model: str = ""
    lora_weights: Optional[str] = None
    data_path: str = ""
    output_dir: str = "./lora-cxr"
    batch_size: int = 128
    micro_batch_size: int = 2
    num_epochs: int = 10
    learning_rate: float = 3e-4
    cutoff_len: int = 1024
    val_set_size: int = 5
    lora_r: int = 8
    lora_alpha: float = 16
    lora_dropout: float = 0.05
    train_on_inputs: bool = False
    add_eos_token: bool = False
    resume_from_checkpoint: Optional[str] = None
    use_embs: bool = False
    use_instruct_data: bool = False
    emb_cache: Optional[str] = None
    eval_steps: int = 400
    mock: bool = False              # tiny seeded model
    synthetic: bool = False         # Vicuna-7B widths, random weights
    seed: int = 42
    max_steps: Optional[int] = None        # cap for smoke runs
    # int8 frozen base: {"w_q", "scale"} projection leaves (6.6 GB at
    # Vicuna-7B instead of 13.5 GB in bf16). Gradients reach only LoRA and
    # img_proj; the dequantizing product is differentiable in its input.
    quantize_base: bool = False
    # attention of 256 tokens or more through the flash-attention kernels
    # and their backward instead of mha under autograd
    flash: bool = False
    device: str = "cuda"


def _make_batcher(records: List[Dict], tokenizer, cfg: FinetuneConfig,
                  llama_cfg: LlamaConfig, emb_cache: Dict[str, np.ndarray]):
    """Tokenize once; returns batch_at(indices) -> a micro-batch of numpy arrays."""
    prompter = Prompter()
    toks = [tokenize_with_masked_prompt(tokenizer, prompter, r, cutoff_len=cfg.cutoff_len,
                                        train_on_inputs=cfg.train_on_inputs,
                                        add_eos_token=cfg.add_eos_token) for r in records]

    def batch_at(indices: List[int]) -> Dict[str, np.ndarray]:
        chosen = [toks[i] for i in indices]
        tokens, lengths = pad_batch_right([c["input_ids"] for c in chosen],
                                          tokenizer.pad_token_id, pad_to=cfg.cutoff_len)
        labels = pad_labels_right([c["labels"] for c in chosen], tokens.shape[1])
        batch = {"tokens": tokens, "labels": labels, "lengths": lengths}
        if cfg.use_embs:
            embs = []
            for i in indices:
                d = str(records[i].get("dicom", ""))
                if d in emb_cache:
                    embs.append(np.asarray(emb_cache[d], np.float32))
                else:   # a deterministic placeholder; crc32 because str
                    # hash() differs from process to process
                    r = np.random.default_rng(zlib.crc32(d.encode()))
                    embs.append(r.normal(size=(llama_cfg.num_img_tokens, llama_cfg.qformer_dim))
                                .astype(np.float32))
            batch["img_embs"] = np.stack(embs)
        return batch

    return batch_at


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _build_model(cfg: FinetuneConfig, device, base: Optional[Dict] = None):
    """(llama_cfg, tokenizer, base, policy) of the mock, the synthetic or the
    checkpoint run; a ``base`` given by the caller is kept."""
    if cfg.mock:
        # positions up to the cutoff need rope rows (the JAX package's
        # gather clamps past max_position instead)
        llama_cfg = dataclasses.replace(
            TINY_LLAMA, num_img_tokens=32,
            max_position=max(TINY_LLAMA.max_position, cfg.cutoff_len))
        # the dequantizing products compute in bf16, as at full width
        policy = BF16 if cfg.quantize_base else FP32
        if base is None:
            base = llama_init(torch.Generator().manual_seed(0), llama_cfg, device="cpu")
            base = tree_map(lambda x: x.to(device),
                            quantize_llama(base) if cfg.quantize_base else base)
    elif cfg.synthetic:
        llama_cfg, policy = VICUNA_7B, BF16
        if base is None:
            gen = torch.Generator(device=device).manual_seed(0)
            if cfg.quantize_base:
                base = random_q8_train_base(llama_cfg, gen, device=device)
            else:
                base = llama_init(gen, llama_cfg, device=device, dtype=torch.bfloat16)
    else:
        # the checkpoint, one layer at a time: the int8 base quantized on the
        # device, or every leaf in bf16
        llama_cfg, policy = VICUNA_7B, BF16
        tokenizer = tokenization.load_vicuna_tokenizer(cfg.base_model)
        if base is None:
            converted = hf_weights.convert_llama(hf_weights._load_hf_state_dict(cfg.base_model),
                                                 llama_cfg.num_layers, stack=False)
            if cfg.quantize_base:
                base = quantize_llama_np(converted, device=device)
            else:
                layers = converted.pop("layers")
                base = tree_map(lambda x: x.to(device, torch.bfloat16), converted)
                base["layers"] = hf_weights.stack_layers(layers, device, torch.bfloat16)
        return llama_cfg, tokenizer, base, policy
    tokenizer = WhitespaceTokenizer(vocab_size=llama_cfg.vocab_size,
                                    num_img_tokens=llama_cfg.num_img_tokens,
                                    img_token_id=llama_cfg.img_token_id)
    return llama_cfg, tokenizer, base, policy


def train(cfg: FinetuneConfig,
          log_fn: Callable[[Dict], None] = lambda m: print(json.dumps(m)),
          on_step: Optional[Callable[[int, Dict], None]] = None,
          base: Optional[Dict] = None, lora: Optional[Dict] = None) -> TrainState:
    """Run the finetune loop; returns the final TrainState.

    ``on_step(step, metrics)`` is called after every micro-step with the
    step's 0-d ``loss`` and ``grad_norm`` tensors (``log_fn`` sees them only
    at step 1 and every 50th) and ``tokens``, the int sum of the micro-batch's
    sequence lengths (padding not counted). ``base`` and ``lora`` replace the trees the
    configuration would build (on ``cfg.device`` already), so that two runs
    can share their weights."""
    if cfg.mock and cfg.synthetic:
        raise ValueError("choose one of mock=True and synthetic=True")
    if not (cfg.mock or cfg.synthetic or cfg.base_model):
        raise ValueError("base_model required (a Vicuna checkpoint directory), or mock=True "
                         "or synthetic=True")
    device = torch.device(cfg.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
        set_precision()
    rng = np.random.default_rng(cfg.seed)

    # ---- model
    llama_cfg, tokenizer, base, policy = _build_model(cfg, device, base)
    if lora is None and cfg.lora_weights:   # f32, as the JAX package loads it
        lora = tree_map(lambda x: x.to(device, torch.float32), hf_weights.convert_peft_lora(
            hf_weights._torch_load(cfg.lora_weights), llama_cfg.num_layers,
            rank=cfg.lora_r, alpha=cfg.lora_alpha))
    if lora is None:   # the mock's on the host, so a CPU run and a card run start alike
        gen_dev = "cpu" if cfg.mock else device
        lora = lora_init(torch.Generator(device=gen_dev).manual_seed(cfg.seed), llama_cfg,
                         device=gen_dev, rank=cfg.lora_r, alpha=cfg.lora_alpha)
        lora = tree_map(lambda x: x.to(device), lora)

    # ---- data
    records = load_instruct_dataset(cfg.data_path)
    val_records = records[:cfg.val_set_size]
    train_records = records[cfg.val_set_size:]
    emb_cache: Dict[str, np.ndarray] = {}
    if cfg.emb_cache and Path(cfg.emb_cache).exists():
        emb_cache = dict(np.load(cfg.emb_cache))
    batch_at = _make_batcher(train_records, tokenizer, cfg, llama_cfg, emb_cache)
    val_batch_at = _make_batcher(val_records, tokenizer, cfg, llama_cfg, emb_cache)

    accum = max(1, cfg.batch_size // cfg.micro_batch_size)
    steps_per_epoch = max(1, len(train_records) // cfg.batch_size) * accum
    total = steps_per_epoch * cfg.num_epochs
    if cfg.max_steps:
        total = min(total, cfg.max_steps)

    # the schedule is given its length in micro-steps and advances once per
    # applied update, as in the JAX package
    tx = make_adamw(linear_warmup_cosine(cfg.learning_rate, cfg.learning_rate / 10,
                                         warmup_steps=100, total_steps=total),
                    weight_decay=0.0, grad_clip=1.0, accum_steps=accum)
    state = TrainState.create(lora, tx)
    step_fn = make_lora_train_step(tx, llama_cfg, policy=policy, flash=cfg.flash)

    @torch.no_grad()
    def eval_fn(params, batch):
        return lora_loss_fn(params, base, llama_cfg, batch, policy, flash=cfg.flash)

    if cfg.resume_from_checkpoint:
        tree, meta = load_checkpoint(Path(cfg.resume_from_checkpoint).parent,
                                     Path(cfg.resume_from_checkpoint).name, target=state)
        state = tree
        log_fn({"resumed_step": int(meta.get("step", 0))})

    keeper = BestKeeper(cfg.output_dir, mode="min")
    rep_idxs, inst_idxs = split_report_instruct(train_records)

    # ---- loop
    step = 0
    t0 = time.time()
    for epoch in range(cfg.num_epochs):
        if cfg.use_instruct_data and rep_idxs and inst_idxs:
            order = balanced_epoch_indices(rep_idxs, inst_idxs, rng)
        else:
            order = rng.permutation(len(train_records)).tolist()
        for i0 in range(0, len(order) - cfg.micro_batch_size + 1, cfg.micro_batch_size):
            host_batch = batch_at(order[i0:i0 + cfg.micro_batch_size])
            state, metrics = step_fn(state, base, _to_device(host_batch, device))
            step += 1
            if on_step is not None:
                on_step(step, {**metrics, "tokens": int(host_batch["lengths"].sum())})
            if step % 50 == 0 or step == 1:
                log_fn({"epoch": epoch, "step": step, "loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "sec": round(time.time() - t0, 1)})
            if step % cfg.eval_steps == 0 or step == total:
                val_losses = []
                for j0 in range(0, len(val_records), cfg.micro_batch_size):
                    idxs = list(range(j0, min(j0 + cfg.micro_batch_size, len(val_records))))
                    while len(idxs) % cfg.micro_batch_size:   # a full micro-batch
                        idxs.append(idxs[-1])
                    vb = _to_device(val_batch_at(idxs), device)
                    val_losses.append(float(eval_fn(state.params, vb)))
                vl = float(np.mean(val_losses)) if val_losses else float("nan")
                improved = keeper.update(step, vl, state.params)
                log_fn({"step": step, "val_loss": vl, "best": improved})
            if cfg.max_steps and step >= cfg.max_steps:
                break
        if cfg.max_steps and step >= cfg.max_steps:
            break

    keeper.update(step, float("inf") if keeper.best is None else keeper.best,
                  state.params)   # a 'last' always exists
    return state


def export_adapter(lora_params, out_path: str) -> None:
    """Write the reference's adapter_model.bin format: lora_A/lora_B per
    layer and the img_proj_layer keys, loadable with torch.load."""
    sd = {}
    layers = lora_params["layers"]
    num_layers = layers[next(iter(layers))]["a"].shape[0]
    for tname, ab in layers.items():
        proj = tname.lstrip("w") + "_proj"   # wq -> q_proj
        a, b = ab["a"].detach().cpu(), ab["b"].detach().cpu()
        for i in range(num_layers):
            pre = f"base_model.model.model.layers.{i}.self_attn.{proj}"
            sd[f"{pre}.lora_A.weight"] = a[i].T.contiguous().clone()
            sd[f"{pre}.lora_B.weight"] = b[i].T.contiguous().clone()
    if "img_proj" in lora_params:
        sd["base_model.model.model.img_proj_layer.weight"] = \
            lora_params["img_proj"]["w"].detach().cpu().T.contiguous().clone()
        sd["base_model.model.model.img_proj_layer.bias"] = \
            lora_params["img_proj"]["b"].detach().cpu().clone()
    torch.save(sd, out_path)


# ---------------------------------------------------------------------- CLI
def _parse_kwargs(argv):
    """Minimal fire-style --key value / --key=value parser."""
    kw = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected argument: {arg}")
        key = arg[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                raise SystemExit(f"missing value for --{key}")
            val = argv[i + 1]
            i += 2
        kw[key] = val
    return kw


def _coerce(val: str, typ):
    if typing.get_origin(typ) is typing.Union:   # Optional[...]
        args = [a for a in typing.get_args(typ) if a is not type(None)]
        typ = args[0] if args else str
    if typ is bool:
        return val.lower() in ("1", "true", "yes")
    if typ is int:
        return int(val)
    if typ is float:
        return float(val)
    return val


def main(argv: Optional[List[str]] = None) -> None:
    """Every FinetuneConfig field is accepted as --name value or --name=value."""
    hints = typing.get_type_hints(FinetuneConfig)
    kwargs = {}
    for k, v in _parse_kwargs(sys.argv[1:] if argv is None else argv).items():
        if k not in hints:
            raise SystemExit(f"unknown option --{k}; valid: {sorted(hints)}")
        kwargs[k] = _coerce(v, hints[k])
    cfg = FinetuneConfig(**kwargs)
    print(f"finetune config: {cfg}")
    train(cfg)


if __name__ == "__main__":
    main()
