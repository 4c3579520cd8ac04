"""Training launcher (the JAX package's ``launch/train.py`` with a
``--device`` flag):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --steps 100 --ckpt /tmp/ck [--device cpu]

As the JAX launcher, it trains the arch's reduced config (``--reduced`` is
on whatever the command line says, as there) with the ``Trainer``.  The
device defaults to the card.  Full width is reached through ``Trainer``
and ``train.make_train_step`` directly.
"""
import argparse

from ..configs import get_arch
from ..data import DataPipeline
from ..train.trainer import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default="/tmp/repro_train")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pipe = DataPipeline(vocab=cfg.vocab, seq_len=args.seq,
                        global_batch=args.batch)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=50, log_every=10,
                         ckpt_dir=args.ckpt, lr_peak=args.lr, lr_warmup=20)
    res = Trainer(cfg, tcfg, pipe, device=args.device).run()
    print(f"done: final loss {res['final_loss']:.4f}, "
          f"{res['steps_run']} steps")


if __name__ == "__main__":
    main()
