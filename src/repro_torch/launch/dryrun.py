"""Multi-pod dry run, PyTorch port of ``repro.launch.dryrun``.

For every (architecture x input shape) cell, run the step function once
for the production mesh — single-pod 16x16 and multi-pod 2x16x16 — on
``DTensor`` inputs over ``meta`` storage (``launch.inputs.build_cell``),
and print its memory, its cost and its collectives from the trace
(``roofline.CostTrace``), and the three-term roofline under the H100
datasheet constants (``roofline.HW``).  A failure here (a sharding
mismatch, an op DTensor cannot place) is a bug in the system.

The 256 or 512 ranks are a ``"fake"`` process group that ``main`` (or
``run_cell``) sets up in this process, rank 0 of it: this module is the
only place they exist, and no collective moves data.  The numbers are
rank 0's.

The reference compiles two scan-unrolled probes (k = 1 and 2 layer
groups) and extrapolates, because XLA's cost analysis counts a while-loop
body once.  The port's trace runs every layer of every group, so it has
no probes.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod --json out.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback

from repro_torch.configs.base import SHAPES, cells, get_config
from repro_torch.launch.inputs import build_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import moe
from repro_torch.roofline.analysis import analyze_cell, model_flops
from repro_torch.train.loop import meta_params


def fake_world(world_size: int) -> None:
    """Make this process rank 0 of a fake default process group of
    ``world_size`` ranks (a group of another size is replaced)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _strided_shard_closed_form(n: int, num_chunks: int, rank: int, split_factor: int):
    """(size, the indices) of ``rank``'s shard of a dim of ``n`` under a
    ``_StridedShard``: the dim cut into ``split_factor`` chunks, each cut
    into ``num_chunks``, the rank taking its piece of each (``torch.chunk``'s
    sizes, empty chunks filled in)."""
    c1 = -(-n // split_factor)
    idx: list[range] = []
    for j in range(split_factor):
        start = min(c1 * j, n)
        length = max(0, min(c1 * (j + 1), n) - start)
        c2 = -(-length // num_chunks)
        lo, hi = min(c2 * rank, length), min(c2 * (rank + 1), length)
        if hi > lo:
            idx.append(range(start + lo, start + hi))
    return sum(map(len, idx)), idx


@contextlib.contextmanager
def closed_form_strided_shards():
    """DTensor's ``_StridedShard.local_shard_size_and_offset`` builds an
    index tensor over the whole dim and chunks it, O(split factor x
    shards) torch calls: with a 32k sequence merged into a sharded head dim
    (the reshapes inside attention's einsum) a call takes about a second,
    and a layer makes several.  Inside this context the method is the same
    arithmetic in closed form (``_strided_shard_closed_form``), after
    checking that the two agree on every small case; on a torch where they
    do not, the original stays."""
    from torch.distributed.tensor import placement_types

    strided = getattr(placement_types, "_StridedShard", None)
    orig = strided.__dict__.get("local_shard_size_and_offset") if strided else None

    def fast(self, curr_local_size, num_chunks, rank, offset_mode=0):
        """``offset_mode``: torch's, 0 FIRST (its default), 1 ALL, 2 NONE."""
        sf = self.split_factor
        if not all(type(v) is int for v in (curr_local_size, num_chunks, rank, sf)):
            return orig(self, curr_local_size, num_chunks, rank, offset_mode)
        m = int(offset_mode)
        size, idx = _strided_shard_closed_form(curr_local_size, num_chunks, rank, sf)
        if m == 2:
            return size, None
        if m == 0:
            return size, idx[0].start if idx else -1
        return size, [i for r in idx for i in r]

    def agree(*mode) -> bool:
        return all(fast(p, n, chunks, rank, *mode) == orig(p, n, chunks, rank, *mode)
                   for n in range(14) for sf in range(1, 6)
                   for p in (strided(0, split_factor=sf),)
                   for chunks in range(1, 5) for rank in range(chunks))

    ok = orig is not None and hasattr(placement_types, "_StridedShardOffsetMode") and all(
        agree(*m) for m in ((), (0,), (1,), (2,)))
    if ok:
        strided.local_shard_size_and_offset = fast
    try:
        yield
    finally:
        if ok:
            strided.local_shard_size_and_offset = orig


def _local_bytes(tree) -> int:
    """Bytes of the local shards of a tree (dicts, tuples) of DTensors."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves as leaves

    return sum(t.to_local().nbytes if isinstance(t, DTensor) else t.nbytes
               for t in leaves(tree) if hasattr(t, "nbytes"))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             verbose: bool = True, extra: dict | None = None):
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    mesh_name = "2x16x16" if multi_pod else "16x16"
    t0 = time.time()
    moe._moe_shard_map.calls = 0
    cell = build_cell(arch, shape_name, mesh, **(extra or {}))
    with closed_form_strided_shards():
        out, trace = cell.lower()
    dt = time.time() - t0
    ep_calls = moe._moe_shard_map.calls

    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    params = meta_params(cfg, max_seq=shape.seq_len if not cfg.use_rope else 4096)
    mf = model_flops(cfg, shape, params)
    rep = analyze_cell(arch, shape_name, mesh_name, trace,
                       model_flops_global=mf, n_devices=mesh.size(),
                       arg_bytes=_local_bytes(cell.args), out_bytes=_local_bytes(out),
                       compile_s=dt)
    if verbose:
        print(f"== {arch} x {shape_name} @ {mesh_name} (trace {dt:.1f}s) ==")
        print(f"   memory (eager, a device): args={rep.arg_bytes / 1e9:.3f}GB "
              f"temp={rep.temp_bytes / 1e9:.3f}GB peak={rep.peak_bytes / 1e9:.3f}GB "
              f"out={rep.out_bytes / 1e9:.3f}GB")
        print(f"   cost: flops/dev={rep.flops_per_dev:.3e} bytes/dev={rep.bytes_per_dev:.3e}")
        print(f"   collectives/dev: {rep.coll_detail}")
        print(f"   expert-parallel MoE calls: {ep_calls}")
        t = rep.terms
        print(f"   roofline: compute={t['compute_s']:.4f}s "
              f"memory={t['memory_s']:.4f}s collective={t['collective_s']:.4f}s "
              f"-> dominant={t['dominant']} "
              f"fraction={t['roofline_fraction']:.3f} "
              f"useful_flops_ratio={rep.useful_flops_ratio:.3f}")
        sys.stdout.flush()
    rep.moe_ep_calls = ep_calls
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every runnable (arch x shape) cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", help="append JSONL reports here")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    metavar="LOGICAL=PHYSICAL",
                    help="logical-axis rule override for perf experiments, "
                         "e.g. --override seq=model (sequence parallelism); "
                         "attn=chunked picks the chunked attention route")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (perf experiment B2)")
    ap.add_argument("--kv-ring", action="store_true",
                    help="ring-buffer local-window KV (perf experiment C1)")
    ap.add_argument("--ssm-chunk", type=int, default=0,
                    help="override SSD chunk length (perf experiment D1)")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, _, v = ov.partition("=")
        overrides[k] = None if v in ("", "none", "None") else v

    todo = []
    if args.all:
        todo = [(a, s) for a, s, skip in cells() if not skip]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        todo = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    reports = []
    for arch, shape in todo:
        for mp in meshes:
            try:
                extra = {"remat": not args.no_remat} \
                    if SHAPES[shape].kind == "train" else {}
                if overrides:
                    extra["rule_overrides"] = overrides
                cfg_ov = {}
                if args.kv_quant:
                    cfg_ov["kv_quant"] = True
                if args.kv_ring:
                    cfg_ov["kv_ring"] = True
                if args.ssm_chunk:
                    cfg_ov["ssm_chunk"] = args.ssm_chunk
                if cfg_ov:
                    extra["cfg_overrides"] = cfg_ov
                rep = run_cell(arch, shape, multi_pod=mp, extra=extra)
                reports.append(rep)
                if args.json:
                    with open(args.json, "a") as f:
                        row = rep.row()
                        row["coll_detail"] = {
                            k: v for k, v in rep.coll_detail.items()}
                        row.update(moe_ep_calls=rep.moe_ep_calls,
                                   flops_per_dev=rep.flops_per_dev,
                                   bytes_per_dev=rep.bytes_per_dev,
                                   coll_bytes_per_dev=rep.coll_bytes_per_dev,
                                   arg_bytes=rep.arg_bytes, peak_bytes=rep.peak_bytes)
                        f.write(json.dumps(row) + "\n")
            except Exception as err:  # noqa: BLE001 - one cell's failure is reported, the rest run
                failures.append((arch, shape, mp))
                print(f"!! FAILED {arch} x {shape} multi_pod={mp}")
                traceback.print_exc()
                if args.json:
                    with open(args.json, "a") as f:
                        f.write(json.dumps({
                            "arch": arch, "shape": shape, "mesh": "2x16x16" if mp else "16x16",
                            "failed": f"{type(err).__name__}: {err}"[:500]}) + "\n")

    print(f"\n{len(reports)} cells compiled OK, {len(failures)} failed")
    for f in failures:
        print("  FAILED:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
