"""The program's side of a cell: the port's configuration objects at a
configuration file's widths, its serving weights made from the
benchmark's float weights (``benchmark/weights.py``) through the port's own
packing, and the image side as the pipeline runs it
(``apps/pipeline.py embed_images``, ``classify_findings``).

Only this file and the drivers import the port (``radialog_tpu_torch``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from . import weights as W


def vocab(config: Dict) -> int:
    """Rows of the served vocabulary: the source's and the tokens added."""
    return config["model"]["vocab_size"] + len(config["added_tokens"])


def llama_config(config: Dict):
    from radialog_tpu_torch.models.llama import LlamaConfig
    m, v = config["model"], config["vision"]
    return LlamaConfig(vocab_size=vocab(config), hidden_size=m["hidden_size"],
                       num_layers=m["num_hidden_layers"], num_heads=m["num_attention_heads"],
                       num_kv_heads=m["num_key_value_heads"],
                       intermediate_size=m["intermediate_size"],
                       max_position=m["max_position_embeddings"], rms_eps=m["rms_norm_eps"],
                       rope_theta=m["rope_theta"], img_token_id=config["added_tokens"]["<IMG>"],
                       num_img_tokens=v["num_query_tokens"], qformer_dim=v["qformer"]["hidden_size"],
                       bos_token_id=m["bos_token_id"], eos_token_id=m["eos_token_id"],
                       pad_token_id=config["pad_token_id"])


def blip2_config(config: Dict):
    from radialog_tpu_torch.models.bert import BertConfig
    from radialog_tpu_torch.models.blip2 import Blip2Config
    from radialog_tpu_torch.models.qformer import QFormerConfig
    v = config["vision"]
    q = v["qformer"]
    bert = BertConfig(hidden_size=q["hidden_size"], num_layers=q["num_layers"],
                      num_heads=q["num_heads"], intermediate_size=q["intermediate_size"],
                      layer_norm_eps=q["layer_norm_eps"])
    return Blip2Config(qformer=QFormerConfig(bert=bert, num_query_tokens=v["num_query_tokens"],
                                             encoder_width=v["encoder_width"],
                                             cross_attention_freq=q["cross_attention_freq"]),
                       image_size=v["image_px"])


def policy(config: Dict):
    from radialog_tpu_torch.ops.layers import BF16, FP32
    return BF16 if config["path"]["compute"] == "bf16" else FP32


def model_reference_dict(config: Dict) -> Dict:
    """The model keys the plain reference reads, with the <IMG> id."""
    return dict(config["model"], img_token_id=config["added_tokens"]["<IMG>"])


def serving_llama(config: Dict, seed: int, device) -> Dict:
    """The LLM weights as the configuration serves them: the benchmark's
    bf16 stacked tree, packed by ``ops/quant.py quantize_llama_host`` for
    W8A8 (the float copy is dropped), or served as it is (the float path's
    stacked layout)."""
    tree = W.llama_weights(config["model"], vocab(config), seed, device,
                           dtype=getattr(torch, config["path"]["float_weights"]))
    if config["path"]["weights"] == "w8a8":
        from radialog_tpu_torch.ops.quant import quantize_llama_host
        packed = quantize_llama_host(tree, device=device, bits=8)
        del tree
        return packed
    if config["path"]["weights"] != "bf16":
        raise ValueError(f"unknown weights {config['path']['weights']!r}")
    return tree


def lora_dtype(config: Dict) -> torch.dtype:
    """The LoRA leaves' type: the compute type, as the pipeline loads them."""
    return torch.bfloat16 if config["path"]["compute"] == "bf16" else torch.float32


def serving_lora(config: Dict, seed: int, device) -> Dict:
    return W.lora_weights(config["model"], config["lora"], config["vision"]["qformer"]["hidden_size"],
                          seed, device, dtype=lora_dtype(config))


@dataclasses.dataclass
class ImageSide:
    """The report's BioViL-T, ln_vision and Q-Former, and the findings
    classifier, with the port's entry points."""

    config: Dict
    seed: int
    device: torch.device
    classifier: bool = True

    def __post_init__(self):
        v = self.config["vision"]
        self.vis_p, self.vis_s = W.vision_weights(v, self.seed, self.device)
        self.qf = W.qformer_weights(v, self.seed, self.device)
        if self.classifier:
            self.cls_p, self.cls_s = W.classifier_weights(v, self.seed, self.device)
        self.blip2 = blip2_config(self.config)
        self.policy = policy(self.config)

    @torch.no_grad()
    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) in [0, 1] -> query embeddings (B, n_query, hidden)."""
        from radialog_tpu_torch.models.biovil_t import biovil_t_apply, patch_tokens_for_qformer
        from radialog_tpu_torch.models.blip2 import blip2_forward_image
        from radialog_tpu_torch.ops.layers import layernorm
        out = biovil_t_apply(self.vis_p, self.vis_s, images, policy=self.policy)
        patch = layernorm(self.qf["ln_vision"], patch_tokens_for_qformer(
            out.projected_patch_embeddings))
        return blip2_forward_image(self.qf, self.blip2, patch, policy=self.policy)

    @torch.no_grad()
    def classify(self, images: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) -> the findings' logits (B, 14) f32."""
        from radialog_tpu_torch.models.chexpert import chexpert_classifier_apply
        return chexpert_classifier_apply(self.cls_p, self.cls_s, images, policy=self.policy)
