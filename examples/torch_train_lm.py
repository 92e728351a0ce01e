"""End-to-end LM training script on the PyTorch port: synthetic data ->
train step -> fault-tolerant runtime with checkpointing (the port of
examples/train_lm.py).

  PYTHONPATH=src python examples/torch_train_lm.py --device cpu   # CPU demo (~8M params, 200 steps)
  PYTHONPATH=src python examples/torch_train_lm.py --full         # ~100M config, on the card
  PYTHONPATH=src python examples/torch_train_lm.py --arch mamba2-370m --device cpu  # any zoo arch (smoke size)

Demonstrates: loss descending on the synthetic stream, checkpoint/restart
(kill it mid-run and re-invoke — it resumes), straggler flagging.
``--device`` defaults to the card, as every entry point of the port does.
"""
import argparse
import dataclasses
import sys

sys.path.insert(0, "src")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true",
                    help="~100M-param config instead of the CPU demo size")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--checkpoint-dir", default="artifacts/train_lm_ckpt")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.launch.train import main as train_main

    argv = ["--arch", args.arch, "--smoke",
            "--steps", str(args.steps),
            "--global-batch", str(args.global_batch),
            "--seq-len", str(args.seq_len),
            "--checkpoint-dir", args.checkpoint_dir,
            "--checkpoint-every", "50",
            "--log-every", "10"]
    if args.device is not None:
        argv += ["--device", args.device]
    if args.full:
        # ~100M: override the smoke config in-place via a registered variant
        import repro_torch.configs.base as B
        from repro_torch.configs import get_config
        base = get_config(args.arch, smoke=True)
        cfg100 = dataclasses.replace(
            base, arch=base.arch + "-100m", n_layers=12, d_model=768,
            n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048,
            vocab_size=32768)
        B.register(base.arch + "-100m", lambda: cfg100, lambda: cfg100)
        argv = ["--arch", base.arch + "-100m"] + argv[2:]
    return train_main(argv)


if __name__ == "__main__":
    sys.exit(main())
