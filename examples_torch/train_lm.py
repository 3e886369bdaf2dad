"""Train a ~100M-parameter LM for a few hundred steps on the synthetic
bigram corpus — the port's end-to-end training driver with
checkpointing. The twin of `examples/train_lm.py`: the same config,
arguments and lines, through `repro_torch.launch.train.train` on the card
by default.

The model is a scaled-down granite-family decoder (~100M params with the
byte-level vocab). Loss falls from ~8.3 (ln 4096) toward the bigram
entropy floor (~3.1 nats), slowly: the 300 steps of 2048 tokens see each
of the 4096 tokens ~150 times, and take the loss down a few tenths of a
nat (`PERF.md` §6 has a run on the card). A checkpoint directory that
already holds a run resumes it, as the reference's does.

Run: PYTHONPATH=src python examples_torch/train_lm.py [--steps 300] [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import train as train_mod

CFG_100M = ModelConfig(
    name="granite-100m", family="dense",
    n_layers=10, d_model=768, n_heads=12, n_kv_heads=4,
    d_ff=2048, vocab_size=4096, head_dim=64,
    norm="rmsnorm", mlp="swiglu", rope_style="standard",
    tie_embeddings=True, attn_chunk=256,
)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the host)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train; return `param_count`, and the driver's `losses`, `grad_norms`,
    `step_ms`, `peak_bytes` (on the card), `final_loss` and `stragglers`."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = CFG_100M
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")

    # patch the lookup the driver reads (`launch.train.get_config`) so that
    # it trains THIS config; restored afterwards
    orig = train_mod.get_config

    def patched_get_config(a, smoke=False):
        return cfg if a == cfg.name else orig(a, smoke)

    train_mod.get_config = patched_get_config
    try:
        out = train_mod.train(
            cfg.name, smoke=True, steps=args.steps, batch=args.batch,
            seq=args.seq, lr=3e-3, ckpt_dir=args.ckpt_dir, ckpt_every=100,
            async_ckpt=True, log_every=20, device=dev)
    finally:
        train_mod.get_config = orig
    print(f"final loss: {out['final_loss']:.4f} "
          f"(start {out['losses'][0]:.4f}, bigram floor ~3.1)")
    keep = ("losses", "grad_norms", "step_ms", "peak_bytes", "final_loss", "stragglers")
    return {"param_count": cfg.param_count(), **{k: out[k] for k in keep}}


if __name__ == "__main__":
    main()
