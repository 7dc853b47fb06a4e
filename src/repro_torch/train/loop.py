"""Fault-tolerant training loop (checkpoint/restart, async saves,
deterministic resume), PyTorch port of ``repro.train.loop``.

``train_loop`` drives (model, optimizer, data) for N steps with:
  - restore-from-latest on entry (crash/preemption restart = rerun);
  - async checkpointing every ``save_every`` steps and at the last step;
  - a ``failure_injector`` hook for tests (simulated preemption at step k
    raises, the next train_loop call resumes from the last checkpoint and
    must reproduce the uninterrupted loss trajectory bit-for-bit given the
    deterministic data pipeline);
  - straggler observability: a step longer than ``step_timeout_s`` is
    logged (single process, so it fences nothing).

Parameters are drawn on ``device`` from a ``torch.Generator`` seeded with
``seed``.  On resume the tree to restore into is built on the ``meta``
device (shapes and dtypes, no storage: the reference's ``jax.eval_shape``).
TokenDataset batches hold tokens and labels only, so a config whose loss
needs a frontend input (whisper-small's ``enc_frames``, internvl2-76b's
``prefix_embeds``) is refused when the loop is called; the reference's loop
fails on them inside its first step.

The result is the reference's plus two host measurements: the loop's wall
seconds and the input prefetcher thread's CPU seconds (Linux
``/proc/self/task/<tid>/stat``; None where that is not readable).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models import Model
from .checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from .data import HostPrefetcher, TokenDataset
from .optimizer import OptConfig, init_opt
from .steps import make_train_step

log = logging.getLogger("repro_torch.train")

__all__ = ["train_loop", "meta_params", "frontend_input"]


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the ``meta`` device: ``Model.init`` with
    it (on a ``meta`` model) builds every leaf's shape and dtype and draws
    and allocates nothing."""

    @property
    def device(self):
        return torch.device("meta")


def meta_params(cfg, *, max_seq: int) -> dict:
    """``Model(cfg).init``'s tree on the ``meta`` device: every leaf's shape
    and dtype, no storage (the reference's ``jax.eval_shape`` of
    ``init``)."""
    return Model(cfg, device="meta").init(_MetaGenerator(), max_seq=max_seq)


def frontend_input(cfg) -> str | None:
    """The batch key a config's loss needs beyond tokens and labels, or
    None: ``enc_frames`` for an encoder-decoder, ``prefix_embeds`` where the
    loss drops ``frontend_len`` prefix positions."""
    if cfg.is_encdec:
        return "enc_frames"
    if cfg.frontend and cfg.frontend_len:
        return "prefix_embeds"
    return None


def _thread_cpu_seconds(native_id: int | None) -> float | None:
    """User + system CPU seconds of one thread of this process."""
    try:
        with open(f"/proc/self/task/{native_id}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except (OSError, IndexError):
        return None
    # after the name: state is field 3, utime and stime fields 14 and 15
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def train_loop(cfg, *, steps: int, ckpt_dir: str, seed: int = 0,
               global_batch: int = 8, seq_len: int = 32,
               opt_cfg: OptConfig | None = None, save_every: int = 20,
               remat: bool = False, failure_injector=None,
               step_timeout_s: float = 120.0, device="cuda") -> dict:
    """Returns {'losses': [...], 'final_step': int, 'resumed_from': int,
    'wall_s': float, 'prefetch_cpu_s': float | None}."""
    missing = frontend_input(cfg)
    if missing is not None:
        raise ValueError(
            f"{cfg.name}: its loss needs batch[{missing!r}], which TokenDataset does not "
            "make (tokens and labels only); train it with make_train_step on batches "
            f"that hold {missing!r}")
    device = resolve_device(device)
    model = Model(cfg, device=device)
    opt_cfg = opt_cfg or OptConfig(lr=1e-3, moment_dtype=cfg.moment_dtype)
    ds = TokenDataset(cfg.vocab_size, seq_len, global_batch, seed=seed)
    step_fn = make_train_step(model, opt_cfg, remat=remat)

    start = latest_step(ckpt_dir)
    if start is not None:
        params_like = meta_params(cfg, max_seq=seq_len * 2)
        opt_like = init_opt(params_like, opt_cfg)
        state, meta = restore_checkpoint(
            ckpt_dir, start, {"params": params_like, "opt": opt_like}, device=device)
        params, opt_state = state["params"], state["opt"]
        resumed_from = start
        first = start
        log.info("resumed from checkpoint step %d", start)
    else:
        params = model.init(torch.Generator(device).manual_seed(seed), max_seq=seq_len * 2)
        opt_state = init_opt(params, opt_cfg)
        resumed_from = -1
        first = 0

    ckpt = AsyncCheckpointer(ckpt_dir)
    # host input overlap: the prefetcher synthesizes batches ahead of the
    # device step, idling Metronome-style rather than spinning
    t_start = time.monotonic()
    prefetch = HostPrefetcher(ds, start_step=first, depth=2)
    losses = []
    try:
        for step in range(first, steps):
            if failure_injector is not None:
                failure_injector(step)
            batch = {k: torch.from_numpy(v).to(device) for k, v in prefetch.get(step).items()}
            t0 = time.monotonic()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            if dt > step_timeout_s:
                log.warning("straggler: step %d took %.1fs (> %.1fs budget)",
                            step, dt, step_timeout_s)
            losses.append(loss)
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {step}")
            if (step + 1) % save_every == 0 or step + 1 == steps:
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          extra={"loss": loss})
    finally:
        # read before stop(): a joined thread has left /proc
        prefetch_cpu_s = _thread_cpu_seconds(prefetch._thread.native_id)
        prefetch.stop()
        # Drain the pending async save even on a crash/preemption exit, or
        # the restart resumes from an older checkpoint than was scheduled.
        ckpt.wait()
    return {"losses": losses, "final_step": steps, "resumed_from": resumed_from,
            "wall_s": time.monotonic() - t_start, "prefetch_cpu_s": prefetch_cpu_s}
