"""Interactive RaDialog demo on the PyTorch port, the counterpart of the
repository's root demo.py: its flags (``--cfg-path``, ``--options``,
``--cli``, ``--mock``, ``--no-report``, ``--spec``, ``--warmup``) and
``--device``; a terminal chat, or the gradio UI where gradio is installed
(without it, the terminal chat).

  python -m radialog_tpu_torch.apps.demo --cli --mock                # on the card
  python -m radialog_tpu_torch.apps.demo --cli --mock --device cpu   # on the CPU
  python -m radialog_tpu_torch.apps.demo --cfg-path cfg.yaml         # gradio UI

The configuration file's ``model`` section names the checkpoints
(``vicuna_path``, ``lora_path``, ``blip2_checkpoint``,
``classifier_checkpoint``, ``chexbert_checkpoint``, ``emb_cache``) and
``mock``, ``quantize``, ``kv_int8``, ``weight_bits``; as in the root demo the
weights are float unless ``quantize`` or 4-bit weights ask otherwise.
"""
from __future__ import annotations

import argparse
import random
import sys

import numpy as np

from ..core.config import Config
from ..data.prompts import IMG_RUN
from .chat import RG_PROMPT, ChatSession
from .pipeline import PipelineConfig, RaDialogPipeline


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="RaDialog demo on the PyTorch port")
    p.add_argument("--cfg-path", default=None, help="path to configuration file")
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--options", nargs="+", default=None, help="key=value config overrides")
    p.add_argument("--cli", action="store_true", default=False,
                   help="terminal chat loop instead of gradio")
    p.add_argument("--mock", action="store_true", default=False)
    p.add_argument("--no-report", action="store_true", default=False,
                   help="don't auto-generate a report on image upload")
    p.add_argument("--spec", action="store_true", default=False,
                   help="prompt-lookup speculative decoding for replies (the same tokens; "
                        "fewer forwards on correction and QA turns)")
    p.add_argument("--warmup", action="store_true", default=False,
                   help="run a throwaway conversation at boot so that the first user turn "
                        "finds the card warm")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback from one to the other")
    return p.parse_args(argv)


def build_session(args) -> ChatSession:
    cfg = Config()
    if args.cfg_path:
        cfg = Config.from_yaml(args.cfg_path)
    if args.options:
        cfg = cfg.apply_overrides(args.options)
    m = cfg.get("model", Config())
    pipe = RaDialogPipeline(PipelineConfig(
        vicuna_path=m.get("vicuna_path"), lora_path=m.get("lora_path"),
        blip2_checkpoint=m.get("blip2_checkpoint"),
        classifier_checkpoint=m.get("classifier_checkpoint"),
        chexbert_checkpoint=m.get("chexbert_checkpoint"),
        emb_cache=m.get("emb_cache"),
        mock=args.mock or bool(m.get("mock", False)),
        quantize=bool(m.get("quantize", False)) or m.get("weight_bits", 8) != 8,
        kv_int8=m.get("kv_int8"),
        weight_bits=int(m.get("weight_bits", 8)), device=args.device))
    return ChatSession(pipe, gen_report=not args.no_report, speculative=args.spec)


def cli_loop(session: ChatSession) -> None:
    print("RaDialog chat — type an image path (.jpg/.png) to upload a scan,\n"
          "'reset' to clear the conversation, 'quit' to exit.")
    while True:
        try:
            text = input("USER: ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            return
        if not text:
            continue
        if text in ("quit", "exit"):
            return
        if text == "reset":
            session.reset()
            print("(conversation cleared)")
            continue
        if text.endswith((".png", ".jpg")):
            reply, findings = session.load_image(text)
            print(f"(predicted findings: {findings})")
            if reply:
                print(f"ASSISTANT: {reply}")
            continue
        print(f"ASSISTANT: {session.ask(text)}")


def make_bot(session: ChatSession):
    """The gradio ``bot`` handler, testable without gradio: takes the chat
    history (last entry the pending user message, an image upload as a
    1-tuple, gradio's add_file convention) and yields the history with the
    assistant's reply streaming in. On the first image upload it also
    shows the report prompt as a history row, the <IMG> run as
    "(img_tokens)", as the reference demo does."""

    def bot(history):
        last = history[-1][0]
        if isinstance(last, tuple):     # image upload
            reply, findings = session.load_image(last[0])
            if len(history) == 1 and session.gen_report:
                shown = RG_PROMPT.replace(f"{IMG_RUN}.", "(img_tokens)")
                history.append([shown.format(findings=findings), None])
            history[-1][1] = ""
            for ch in reply or "":
                history[-1][1] += ch
                yield history
            if not reply:
                history[-1][1] = f"(predicted findings: {findings})"
                yield history
            return
        history[-1][1] = ""
        for partial in session.ask_stream(last):
            history[-1][1] = partial
            yield history

    return bot


def gradio_ui(session: ChatSession) -> None:
    try:
        import gradio as gr
    except ImportError:
        print("gradio is not installed — falling back to --cli mode", file=sys.stderr)
        return cli_loop(session)

    bot = make_bot(session)

    def add_text(history, text):
        return history + [(text, None)], gr.update(value="", interactive=False)

    def add_file(history, file):
        return history + [((file.name,), None)]

    def clear_history(_history):
        session.reset()
        return []

    with gr.Blocks() as ui:
        chatbot = gr.Chatbot([], elem_id="chatbot")
        with gr.Row():
            txt = gr.Textbox(show_label=False, container=False,
                             placeholder="Enter text and press enter, or upload an image")
        with gr.Row():
            btn = gr.UploadButton("📁 Upload image", file_types=["image"], scale=1)
            clear_btn = gr.Button("Clear History", scale=1)
        clear_btn.click(clear_history, [chatbot], [chatbot])
        txt_msg = txt.submit(add_text, [chatbot, txt], [chatbot, txt],
                             queue=False).then(bot, chatbot, chatbot)
        txt_msg.then(lambda: gr.update(interactive=True), None, [txt], queue=False)
        btn.upload(add_file, [chatbot, btn], [chatbot], queue=False).then(bot, chatbot, chatbot)
    ui.queue()
    ui.launch()


def main(argv=None) -> None:
    random.seed(16)
    np.random.seed(16)
    args = parse_args(argv)
    session = build_session(args)
    if args.warmup:
        print(f"(warmup: {session.warmup():.1f}s)", file=sys.stderr)
    if args.cli:
        cli_loop(session)
    else:
        gradio_ui(session)


if __name__ == "__main__":
    main()
