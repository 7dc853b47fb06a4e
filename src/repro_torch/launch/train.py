"""Training launcher CLI, PyTorch port of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --smoke
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
      --steps 100 --batch 8 --seq 256 --ckpt runs/run1        # resumable

Any --arch but whisper-small and internvl2-76b (their loss needs a
frontend input that the token dataset does not make); --smoke uses the
reduced config.  Runs on CUDA unless --device says otherwise.  The loop
is fault tolerant: rerunning the same command after a crash resumes from
the latest checkpoint and reproduces the uninterrupted loss trajectory
(deterministic data pipeline).
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, list_configs
from repro_torch.train import OptConfig, train_loop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device for parameters and optimizer state (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    res = train_loop(cfg, steps=args.steps, ckpt_dir=args.ckpt,
                     global_batch=args.batch, seq_len=args.seq,
                     save_every=args.save_every, remat=args.remat,
                     opt_cfg=OptConfig(lr=args.lr,
                                       moment_dtype=cfg.moment_dtype),
                     device=args.device)
    print(f"arch={cfg.name} steps={res['final_step']} "
          f"resumed_from={res['resumed_from']} "
          f"loss {res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
