"""Text generation from an LM checkpoint, the port's ``generate.py``:
``python -m ps_pytorch_tpu_torch.generate``.

Takes the root ``generate.py``'s flags plus ``--device`` (default
``cuda``): it loads ``model_step_<k>`` (the newest with ``--step 0``) of a
``train_lm`` run of either package, builds the model from the
checkpoint's own config, decodes with the k/v cache
(``models/generate.py``) and prints the same JSON line, then the decoded
text. The byte-level LM needs no tokenizer: the prompt is UTF-8 bytes, the
output bytes decoded. Legacy (pre-q/k/v-split) checkpoints migrate on load.

    python -m ps_pytorch_tpu_torch.generate --train-dir ./lm \\
        --prompt "def train(" --n-new 256 [--temperature 0] [--device cpu]
"""

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="ps_pytorch_tpu_torch generate")
    p.add_argument("--train-dir", required=True)
    p.add_argument("--step", type=int, default=0,
                   help="checkpoint step (0 = newest)")
    p.add_argument("--prompt", default="\n",
                   help="UTF-8 prompt text (byte-level LM: bytes are the "
                        "vocabulary)")
    p.add_argument("--n-new", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.8,
                   help="0 = greedy")
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default cuda)")
    args = p.parse_args(argv)

    import numpy as np

    from ps_pytorch_tpu_torch.config import checkpoint_config
    from ps_pytorch_tpu_torch.models.generate import generate
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.runtime.lm_eval import (
        build_lm_oracle, build_lm_template, restore_lm,
    )
    from ps_pytorch_tpu_torch.runtime.trainer import (
        resolve_device, set_reference_numerics,
    )

    set_reference_numerics()
    device = resolve_device(args.device)
    step = args.step or ckpt.latest_step(args.train_dir)
    if step is None:
        p.error(f"no model_step_<k> checkpoints in {args.train_dir}")
    with open(f"{ckpt.checkpoint_path(args.train_dir, step)}/config.json") as f:
        cfg = checkpoint_config(f.read())
    model, _ = build_lm_oracle(cfg, device)
    opt_state = build_lm_template(cfg, model)
    ckpt.load_checkpoint(args.train_dir, step, lambda tree: restore_lm(
        tree, model, opt_state, step=step))

    prompt_bytes = args.prompt.encode("utf-8")
    if not prompt_bytes:
        p.error("--prompt must be non-empty")
    if args.n_new < 1:
        p.error(f"--n-new {args.n_new} (need >= 1)")
    if args.top_k < 0:
        p.error(f"--top-k {args.top_k} (need >= 0; 0 = no truncation)")
    if max(prompt_bytes) >= cfg.lm_vocab:
        p.error(f"prompt contains byte {max(prompt_bytes)} but the "
                f"checkpoint's vocabulary is {cfg.lm_vocab}")
    if len(prompt_bytes) + args.n_new > cfg.lm_seq_len:
        p.error(f"prompt ({len(prompt_bytes)} B) + --n-new ({args.n_new}) "
                f"exceeds the checkpoint's sequence length "
                f"({cfg.lm_seq_len})")
    prompt = np.frombuffer(prompt_bytes, np.uint8)[None].astype(np.int64)
    out = generate(model, prompt, n_new=args.n_new,
                   temperature=args.temperature, top_k=args.top_k,
                   seed=args.seed)
    text = bytes(out[0].cpu().numpy().astype(np.uint8)).decode(
        "utf-8", "replace")
    print(json.dumps({"step": step, "prompt_bytes": len(prompt_bytes),
                      "generated_bytes": args.n_new}))
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
